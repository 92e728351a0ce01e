"""Planted faults and check sizes shared by the MoE tests of the port and by
``chip_smoke.py``'s phase 28 and ``tests/_torch_moe_noise.py`` (no JAX
here)."""
import contextlib
import dataclasses
import math
from fractions import Fraction

import repro_torch.models.moe as moe_module


@contextlib.contextmanager
def slots_swapped(token: int = 0):
    """While active, every routing gives the first token of each group
    (``token``) its two first slots' gate weights the other way round:
    each of its top-2 experts is weighted by the other's gate.  The fault
    that decode against forward must see in a routed FFN."""
    real = moe_module.route

    def route(xg, router, k, capacity):
        probs, gates, idx, pos, keep = real(xg, router, k, capacity)
        gates = gates.clone()
        gates[:, token, [0, 1]] = gates[:, token, [1, 0]]
        return probs, gates, idx, pos, keep

    moe_module.route = route
    try:
        yield
    finally:
        moe_module.route = real


def no_drop_config(cfg, tokens: int):
    """``cfg`` with one group holding every token of a call up to
    ``tokens`` and a capacity of the whole group, so nothing is dropped and
    the output of a token does not depend on the others: decode (a group
    of B tokens) then matches the train-mode forward over any length, where
    JAX's rule would need every length a multiple of the group.  The
    capacity factor is E / k, or the next float up where E / k rounds down
    (64 / 6), so that int(gs * k * cf / E) is at least gs for every gs."""
    cf = cfg.n_experts / cfg.top_k
    while Fraction(cf) * cfg.top_k < cfg.n_experts:
        cf = math.nextafter(cf, math.inf)
    return dataclasses.replace(cfg, moe_group_size=tokens,
                               capacity_factor=cf)
