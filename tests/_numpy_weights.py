"""Numpy weights for a reference spec tree, for the port's parity tests.

Every leaf is random: a normal at the Spec's std (its ``scale``, else
1/sqrt(fan_in) with fan_in = shape[-2], as the reference's init), and
the zero- and one-init leaves (the token-shift mix, the decay LoRA, the
bonus, A's log, biases, norm scales) at 0 and 1 plus a normal of 0.1,
so that no term of a layer's algebra is hidden by a zero. The reference's
own init takes seconds at the reduced configs; this takes milliseconds.
"""
import math

import numpy as np


def numpy_tree(specs, seed: int, spec_type):
    """``specs``: nested dicts whose leaves are ``spec_type`` (the
    reference's ``Spec``); the same tree of float32 arrays, drawn in the
    tree's order from ``np.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)

    def draw(s):
        z = rng.standard_normal(s.shape).astype(np.float32)
        if s.init != "normal":
            return float(s.init == "ones") + 0.1 * z
        fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
        std = s.scale if s.scale is not None else 1 / math.sqrt(fan_in)
        return std * z

    def walk(t):
        return draw(t) if isinstance(t, spec_type) else \
            {k: walk(v) for k, v in t.items()}
    return walk(specs)
