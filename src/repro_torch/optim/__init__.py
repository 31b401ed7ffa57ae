"""Optimizer-side helpers of the distributed trainer (port of
``repro.optim``): gradient wire compression (``compress``)."""
