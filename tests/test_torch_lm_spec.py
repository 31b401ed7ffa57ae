"""The port's LM specs, architecture registry and parameter trees
(``repro_torch.models.spec``, ``repro_torch.configs``,
``repro_torch.models.params``) against the reference's.  Oracles:
``tests/test_system.py:34``, ``:44``, ``:71``, ``:80``."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.models import params as ref_params  # noqa: E402
from repro.models import spec as ref_spec_mod  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import params, spec as spec_mod  # noqa: E402

ARCHS = configs.all_arch_ids()
POLICIES = ("tp", "fsdp", "fsdp_pod")
MESHES = (("data", "model"), ("pod", "data", "model"), ("model",), ())


def both_specs(arch, kind):
    get = "get_spec" if kind == "spec" else "get_smoke"
    return getattr(ref_configs, get)(arch), getattr(configs, get)(arch)


def test_registry_matches_reference():
    assert configs.ARCHS == ref_configs.ARCHS
    assert configs.ALIASES == ref_configs.ALIASES
    assert configs.all_arch_ids() == ref_configs.all_arch_ids()
    assert set(configs.ALIASES) == {
        "minicpm-2b", "h2o-danube-1.8b", "qwen1.5-4b", "codeqwen1.5-7b",
        "llama4-maverick-400b-a17b", "mixtral-8x22b", "mamba2-780m",
        "jamba-v0.1-52b", "whisper-tiny", "paligemma-3b",
    }
    # module names and dashed ids both resolve
    assert configs.get_spec("qwen1_5_4b") is configs.get_spec("qwen1.5-4b")
    assert configs.get_gs_dataset("kingsnake").name == "kingsnake"


@pytest.mark.parametrize("kind", ["spec", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_spec_fields_and_derived_properties_match(arch, kind):
    want, got = both_specs(arch, kind)
    assert type(got).__module__ == "repro_torch.models.spec"
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for name in ("hd", "padded_vocab", "padded_n_q", "padded_n_kv", "q_group",
                 "kv_shardable", "attn_every_layer"):
        assert getattr(got, name) == getattr(want, name), name
    assert got.n_superblocks == want.n_superblocks
    for layer in range(got.n_layers):
        slot = layer % got.period
        assert got.is_attn_slot(slot) == want.is_attn_slot(slot)
        assert got.is_moe_slot(slot, layer) == want.is_moe_slot(slot, layer)
    assert got.param_count() == want.param_count()
    assert got.param_count(active_only=True) == want.param_count(active_only=True)
    # the invariants of tests/test_system.py:44
    assert got.n_layers % got.period == 0
    if got.n_q:
        assert got.padded_n_q % got.padded_n_kv == 0
    assert got.padded_vocab % (128 * spec_mod.MODEL_AXIS_SIZE) == 0


def test_published_param_counts_near_published():
    """tests/test_system.py:71, on the port's SPECs."""
    for arch, (n, tol) in {"minicpm-2b": (2.7e9, 0.35), "qwen1.5-4b": (4e9, 0.35),
                           "codeqwen1.5-7b": (7e9, 0.35),
                           "mixtral-8x22b": (141e9, 0.25),
                           "mamba2-780m": (780e6, 0.35)}.items():
        assert abs(configs.get_spec(arch).param_count() - n) / n < tol, arch


def test_pad_to_and_axes():
    for x in (0, 1, 15, 16, 17, 2047, 151936):
        for m in (1, 16, 2048):
            assert spec_mod.pad_to(x, m) == ref_spec_mod.pad_to(x, m)
    assert spec_mod.MODEL_AXIS_SIZE == ref_spec_mod.MODEL_AXIS_SIZE
    assert spec_mod.LOGICAL_AXES == ref_spec_mod.LOGICAL_AXES
    with pytest.raises(ValueError):
        spec_mod.rules_for("zero3")


@pytest.mark.parametrize("kv_shardable", [False, True])
@pytest.mark.parametrize("policy", POLICIES)
def test_rules_and_pspecs_match(policy, kv_shardable):
    assert spec_mod.rules_for(policy, kv_shardable) == \
        ref_spec_mod.rules_for(policy, kv_shardable)
    logicals = [(ax,) for ax in spec_mod.LOGICAL_AXES] + [
        (None, "embed", "q_heads"), ("layers", "experts", "embed", "ff"),
        ("batch", "seq", None), ("vocab", "embed_act"),
    ]
    for mesh in MESHES:
        for logical in logicals:
            want = ref_spec_mod.logical_to_pspec(logical, policy, mesh, kv_shardable)
            got = spec_mod.logical_to_pspec(logical, policy, mesh, kv_shardable)
            assert got == tuple(want), (logical, mesh)


def flat(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from flat(v, path + (k,))
    else:
        yield path, tree


@pytest.mark.parametrize("kind", ["spec", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_defs_and_specs_match(arch, kind):
    want, got = both_specs(arch, kind)
    wd = dict(flat(ref_params.param_defs(want)))
    gd = dict(flat(params.param_defs(got)))
    assert list(gd) == list(wd)
    for path, d in gd.items():
        w = wd[path]
        assert (d.shape, d.logical, d.scale) == (w.shape, w.logical, w.scale), path
    metas = dict(flat(params.param_specs(got)))
    assert list(metas) == list(gd)
    for path, t in metas.items():
        assert t.device.type == "meta" and t.dtype == torch.bfloat16
        assert tuple(t.shape) == gd[path].shape
    assert params.PARAM_DTYPE == torch.bfloat16


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_shapes_dtypes_and_padding(arch):
    want, got = both_specs(arch, "smoke")
    ref = dict(flat(jax.tree.map(np.asarray, ref_params.init_params(
        want, jax.random.PRNGKey(0)))))
    mine = params.init_params(got, torch.Generator().manual_seed(0), device="cpu")
    leaves = dict(flat(mine))
    assert sorted(leaves) == sorted(ref)
    for path, t in leaves.items():
        assert tuple(t.shape) == ref[path].shape, path
        assert t.dtype == torch.bfloat16 and str(ref[path].dtype) == "bfloat16"
        d = dict(flat(params.param_defs(got)))[path]
        if d.scale == 0.0:
            assert not t.any(), path
        elif d.scale == -1.0:               # A_log = log(uniform[1, 16])
            a = t.float()
            assert 0.0 <= float(a.min()) and float(a.max()) <= np.log(16) + 0.02
        elif path[0] not in ("embed", "head"):  # N(0, scale^2)
            assert abs(float(t.float().std()) - d.scale) < 0.5 * d.scale, path
    v = got.vocab
    assert not mine["embed"][v:].any()
    assert abs(float(mine["embed"][:v].float().std()) - 0.02) < 0.01
    if "head" in mine:
        assert not mine["head"][:, v:].any()
    f32 = params.init_params(got, torch.Generator().manual_seed(0),
                             dtype=torch.float32, device="cpu")
    assert all(t.dtype == torch.float32 for _, t in flat(f32))
    again = params.init_params(got, torch.Generator().manual_seed(0),
                               dtype=torch.float32, device="cpu")
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(flat(f32), flat(again)))


def test_params_from_numpy_bridges_bf16_and_f32():
    spec = ref_configs.get_smoke("jamba-v0.1-52b")
    for dtype in (jnp.bfloat16, jnp.float32):
        ref = jax.tree.map(np.asarray, ref_params.init_params(
            spec, jax.random.PRNGKey(1), dtype=dtype))
        mine = dict(flat(params.params_from_numpy(ref, device="cpu")))
        assert sorted(mine) == sorted(dict(flat(ref)))
        for pa, b in flat(ref):
            a = mine[pa]
            want = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
            assert a.dtype == want
            assert np.array_equal(a.float().numpy(), b.astype(np.float32)), pa
    cast = params.params_from_numpy(ref, device="cpu", dtype=torch.float64)
    assert all(t.dtype == torch.float64 for _, t in flat(cast))
