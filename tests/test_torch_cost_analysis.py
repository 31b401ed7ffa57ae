"""The port's cost analyzer (``repro_torch.launch.cost_analysis``) against
the reference's HLO analyzer (``repro.launch.hlo_analysis``).

The eight cases of ``tests/test_hlo_analysis.py`` are written here in
torch, with the same assertions and bounds, and each runs the reference's
function beside it on the same program: the dot's FLOPs equal the
reference's ``analyze`` at rel 0.01, ``_wire_bytes`` equals the reference's
on a grid of (kind, operand, output, group), and ``group_span`` on rank
lists equals ``_parse_groups`` on the ``replica_groups`` strings that
denote the same groups (the iota forms included).  Then: ``einsum`` is
counted once, ``dryrun.model_flops`` equals the reference's exactly for
every arch x shape at SPEC and SMOKE, and three SMOKE cells' FLOPs agree
with the reference's compiled module within 10%.
"""

import collections
import itertools
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

from repro.configs import get_smoke as ref_get_smoke  # noqa: E402
from repro.configs import get_spec as ref_get_spec  # noqa: E402
from repro.launch import hlo_analysis as H  # noqa: E402
from repro_torch.configs import all_arch_ids, get_smoke, get_spec  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.cost_analysis import (_wire_bytes, analyze,  # noqa: E402
                                              group_span)
from repro_torch.models.steps import SHAPES  # noqa: E402

from _torch_tooling import reference_dryrun  # noqa: E402


def compile_text(f, *args):
    return jax.jit(f).lower(*args).compile().as_text()


def flops_by_opcode(text: str) -> collections.Counter:
    """The reference's ``analyze`` FLOPs of a compiled module, by opcode
    (fusion, while, call and conditional bodies walked as ``_comp_costs``
    walks them, a while body times its trip count)."""
    mod = H.HloModule(text)
    out = collections.Counter()

    def walk(comp, mult):
        for inst in mod.insts[comp]:
            c = H.HloCosts()
            mod._inst_costs(inst, c, False)
            out[inst.opcode] += c.flops * mult
            if inst.opcode == "fusion":
                m = H.CALLS_RE.search(inst.line)
                if m:
                    walk(m.group(1), mult)
            elif inst.opcode == "while":
                bm, tm = H.BODY_RE.search(inst.line), H.TRIP_RE.search(
                    inst.line)
                if bm:
                    walk(bm.group(1), mult * (int(tm.group(1)) if tm else 1))
            elif inst.opcode in ("call", "conditional", "custom-call"):
                m = re.search(
                    r"(?:to_apply|called_computations)=\{?%?([\w\.\-]+)",
                    inst.line)
                if m and m.group(1) in mod.insts:
                    walk(m.group(1), mult)

    walk(mod.entry, 1)
    return out


def test_dot_flops_exact():
    r = analyze(lambda x, y: x @ y, torch.zeros(32, 64), torch.zeros(64, 128))
    assert r["flops"] == pytest.approx(2 * 32 * 64 * 128, rel=0.01)
    ref = H.analyze(compile_text(lambda x, y: x @ y, jnp.zeros((32, 64)),
                                 jnp.zeros((64, 128))))
    assert r["flops"] == pytest.approx(ref["flops"], rel=0.01)
    assert r["matmul_flops"] == 2 * 32 * 64 * 128


def test_scan_trip_count_multiplies():
    """A Python loop is charged on every pass, as the reference multiplies
    a while body by its trip count."""
    def f(x, Ws):
        for w in Ws:
            x = torch.tanh(x @ w)
        return x.sum()

    def f_ref(x, Ws):
        def body(x, w):
            return jnp.tanh(x @ w), None
        return lax.scan(body, x, Ws)[0].sum()

    dots = 8 * 2 * 4 * 64 * 64
    r = analyze(f, torch.zeros(4, 64), torch.zeros(8, 64, 64))
    ref = H.analyze(compile_text(f_ref, jnp.zeros((4, 64)),
                                 jnp.zeros((8, 64, 64))))
    for flops in (r["flops"], ref["flops"]):
        assert dots <= flops <= dots * 1.3
    assert r["matmul_flops"] == dots


def test_scan_hbm_counts_slices_not_whole_buffer():
    """16 layers x (64x64) weights: each pass reads one layer (16 KB), not
    the whole 256 KB stack (a layer of the stack is a view)."""
    def f(x, Ws):
        for w in Ws:
            x = x @ w
        return x.sum()

    def f_ref(x, Ws):
        return lax.scan(lambda x, w: (x @ w, None), x, Ws)[0].sum()

    whole_stack_every_trip = 16 * (16 * 64 * 64 * 4)
    r = analyze(f, torch.zeros(1, 64), torch.zeros(16, 64, 64))
    ref = H.analyze(compile_text(f_ref, jnp.zeros((1, 64)),
                                 jnp.zeros((16, 64, 64))))
    for hbm in (r["hbm_bytes"], ref["hbm_bytes"]):
        assert hbm < whole_stack_every_trip / 2


def test_no_collectives_on_single_device():
    r = analyze(lambda x: (x * 2).sum(), torch.zeros(128))
    ref = H.analyze(compile_text(lambda x: (x * 2).sum(), jnp.zeros((128,))))
    for s in (r, ref):
        assert s["collective_wire_bytes"] == 0
        assert s["n_collective_sites"] == 0
    assert r["collectives"] == {}


def test_wire_models():
    # all-gather: out - in
    assert _wire_bytes("all-gather", 100, 800, 8) == 700
    # ring all-reduce: 2x(g-1)/g
    assert _wire_bytes("all-reduce", 800, 800, 8) == 2 * 800 * 7 // 8
    assert _wire_bytes("reduce-scatter", 800, 100, 8) == 800
    # group of 1 = free
    assert _wire_bytes("all-reduce", 800, 800, 1) == 0
    for kind, operand, output, group in itertools.product(
            H.COLLECTIVES, (0, 100, 801), (0, 100, 800, 6400),
            (0, 1, 2, 3, 8)):
        assert _wire_bytes(kind, operand, output, group) == H._wire_bytes(
            kind, operand, output, group), (kind, operand, output, group)


#: replica_groups strings and the rank lists they denote (pod sizes 2, 4)
GROUPS = [
    ("replica_groups={{0,1},{2,3}}", [[0, 1], [2, 3]]),
    ("replica_groups={{0,2},{1,3}}", [[0, 2], [1, 3]]),
    ("replica_groups={{0,1,2,3}}", [[0, 1, 2, 3]]),
    ("replica_groups=[2,4]<=[8]", [[0, 1, 2, 3], [4, 5, 6, 7]]),
    ("replica_groups=[4,2]<=[2,4]T(1,0)", [[0, 4], [1, 5], [2, 6], [3, 7]]),
    ("replica_groups=[1,8]<=[8]", [list(range(8))]),
]


def test_replica_group_pod_span_detection():
    assert group_span([[0, 1], [2, 3]], pod_size=2) == (2, False)
    assert group_span([[0, 2], [1, 3]], pod_size=2) == (2, True)
    for line, ranks in GROUPS[:3]:
        for pod in (0, 1, 2, 4):
            assert group_span(ranks, pod) == H._parse_groups(line, pod), \
                (line, pod)


def test_replica_group_iota_format():
    # {0..3},{4..7} within pods
    assert group_span([[0, 1, 2, 3], [4, 5, 6, 7]], pod_size=4) == (4, False)
    # pairs {0,4},... cross pods
    assert group_span([[0, 4], [1, 5], [2, 6], [3, 7]],
                      pod_size=4) == (2, True)
    for line, ranks in GROUPS[3:]:
        for pod in (0, 2, 4, 8):
            assert group_span(ranks, pod) == H._parse_groups(line, pod), \
                (line, pod)


def test_conv_flops_order_of_magnitude():
    def f(x, k):
        return torch.nn.functional.conv2d(x, k, padding="same").sum()

    def f_ref(x, k):
        return lax.conv_general_dilated(
            x, k, (1, 1), "SAME",
            dimension_numbers=("NCHW", "OIHW", "NCHW")).sum()

    expect = 2 * (1 * 8 * 16 * 16) * (3 * 3 * 3)
    r = analyze(f, torch.zeros(1, 3, 16, 16), torch.zeros(8, 3, 3, 3))
    ref = H.analyze(compile_text(f_ref, jnp.zeros((1, 3, 16, 16)),
                                 jnp.zeros((8, 3, 3, 3))))
    for flops in (r["flops"], ref["flops"]):
        assert expect * 0.5 <= flops <= expect * 2.0


@pytest.mark.parametrize("inference", [False, True])
def test_einsum_counted_once(inference):
    """``einsum`` reaches the mode as the ``bmm`` it decomposes into (with
    autograd on), or whole (under ``inference_mode``, where the analyzer
    decomposes it): either way one bmm's FLOPs and no einsum row."""
    x, y = torch.zeros(4, 8, 16), torch.zeros(4, 16, 32)

    def f(a, b):
        if inference:
            with torch.inference_mode():
                return torch.einsum("bij,bjk->bik", a, b)
        return torch.einsum("bij,bjk->bik", a, b)

    r = analyze(f, x, y)
    assert r["flops"] == r["matmul_flops"] == 2 * 4 * 8 * 16 * 32
    assert list(r["per_op"]) == ["aten.bmm"]
    assert r["per_op"]["aten.bmm"]["count"] == 1


def test_model_flops_equal_reference():
    ref = reference_dryrun()
    for arch in all_arch_ids():
        for get, ref_get in ((get_spec, ref_get_spec),
                             (get_smoke, ref_get_smoke)):
            for shape in SHAPES:
                assert dryrun.model_flops(get(arch), shape) == \
                    ref.model_flops(ref_get(arch), shape), (arch, shape)


SMOKE_CELLS = [("minicpm-2b", "train_4k"), ("minicpm-2b", "prefill_32k"),
               ("mixtral-8x22b", "train_4k")]


@pytest.mark.parametrize("arch,shape", SMOKE_CELLS)
def test_smoke_cell_flops_match_reference(arch, shape):
    """The port's count of a SMOKE cell's step on ``meta`` tensors against
    the reference's ``analyze`` of the same cell compiled on a 1x1 mesh.
    The matmuls agree within 1e-3 (the reference's dots are the same
    products); the totals within 10%: the port counts 0.94-0.98 of the
    reference, because XLA materialises broadcasts (of masks, scales and
    biases; 2.0-7.8 TFLOP a cell at 1 flop an element) that eager PyTorch
    takes as free ``expand`` views, and their elementwise ops differ
    (XLA's converts and selects against PyTorch's in-place masks)."""
    ref_dr = reference_dryrun()
    text = ref_dr.lower_lm_cell(ref_get_smoke(arch), shape, jax.make_mesh(
        (1, 1), ("data", "model"))).compile().as_text()
    ref = H.analyze(text)
    by_op = flops_by_opcode(text)
    assert sum(by_op.values()) == pytest.approx(ref["flops"], rel=1e-9)
    got = dryrun.lm_cell(get_smoke(arch), shape)
    assert got["n_collective_sites"] == ref["n_collective_sites"] == 0
    assert got["matmul_flops"] == pytest.approx(by_op["dot"], rel=1e-3)
    assert 0.9 <= got["flops"] / ref["flops"] <= 1.1, (got["flops"],
                                                       ref["flops"])
    assert np.isclose(got["flops"], sum(r["flops"]
                                        for r in got["per_op"].values()))
