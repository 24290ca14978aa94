"""The MoE dispatch's slot positions on the CPU: the plain version
(``models/moe.py:_positions_plain``, the card tests' oracle for
csrc/moe_positions.cu) against a direct count, the route ``_positions``
takes off the card, and the kernel wrapper's refusals, which come
before any launch. The kernel itself is held to the plain version in
tests/test_torch_cuda.py."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import obs  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.kernels.moe_positions import kernel as positions_k  # noqa: E402,E501
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402


def direct_positions(top_e: np.ndarray) -> np.ndarray:
    """Each choice's count of earlier same-expert choices in its group,
    token-major, by a walk over the choices."""
    b, s, k = top_e.shape
    pos = np.empty((b, s * k), dtype=np.int64)
    for g, row in enumerate(top_e.reshape(b, s * k)):
        seen: dict = {}
        for i, ex in enumerate(row.tolist()):
            pos[g, i] = seen.get(ex, 0)
            seen[ex] = pos[g, i] + 1
    return pos.reshape(b, s, k)


def choices(b, s, k, e, seed, distinct=True):
    """(B, S, k) experts: each token's k distinct ones (as top-k gives
    them) or drawn with repeats."""
    rng = np.random.default_rng(seed)
    if distinct:
        return np.argsort(rng.random((b, s, e)), axis=-1)[..., :k]
    return rng.integers(0, e, (b, s, k))


# name: (B, S, k, E, capacity, distinct, drops). Capacity None is the
# model's at a capacity factor of 1.25 (moe._capacity); decode's is the
# batch, as blocks.py gives it. The first three are the benchmark cells'
# shapes (train-4k, train-8k, prefill) at E = 64.
POSITION_CASES = {
    "train_4k": (1, 4096, 6, 64, None, True, False),
    "train_8k": (1, 8192, 6, 64, None, True, False),
    "prefill": (4, 1024, 6, 64, None, True, True),
    "one_group": (1, 300, 6, 64, None, True, True),
    "four_groups": (4, 100, 6, 64, None, True, True),
    "decode": (8, 1, 6, 64, 8, True, False),
    "experts_not_a_power_of_two": (2, 77, 2, 5, 25, True, True),
    "one_expert": (3, 50, 1, 1, None, True, False),
    "no_tile_divides": (2, 1367, 6, 64, None, True, True),
    "repeats_within_a_token": (2, 64, 4, 3, None, False, True),
    "every_choice_on_one_expert": (2, 40, 6, None, None, None, True),
    "capacity_above_s": (2, 30, 6, 8, 35, True, False),
}


@pytest.mark.parametrize("case", list(POSITION_CASES))
def test_positions_plain_is_the_direct_count(case):
    b, s, k, e, c, distinct, drops = POSITION_CASES[case]
    if e is None:                       # every choice on expert 3 of 64
        e, top_e = 64, np.full((b, s, k), 3)
    else:
        top_e = choices(b, s, k, e, seed=s * k + e, distinct=distinct)
    if c is None:
        c = max(1, min(s, int(s * k * 1.25 / e) + 1))
    want = direct_positions(top_e)
    pos, keep = moe._positions_plain(torch.from_numpy(top_e), e, c)
    assert pos.dtype == torch.int64 and keep.dtype == torch.bool
    np.testing.assert_array_equal(pos.numpy(), want)
    np.testing.assert_array_equal(keep.numpy(), want < c)
    assert bool((~keep).any()) == drops


@pytest.mark.parametrize("dispatch", ["einsum", "gather"])
def test_positions_on_the_cpu_take_the_plain_route(dispatch):
    """No kernel launch: every routed choice is placed by the plain
    route."""
    base = get_reduced("deepseek-moe-16b")
    cfg = dataclasses.replace(base, dtype="float32", moe=dataclasses.replace(
        base.moe, dispatch=dispatch))
    m = LM(cfg, device="cpu", seed=0)
    tokens = torch.randint(0, cfg.vocab, (2, 16),
                           generator=torch.Generator().manual_seed(1))
    tb = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    launched = positions_k.positions.launches
    tel = obs.Telemetry()
    with torch.no_grad(), obs.use(tel):
        m.loss(tb, attention="plain")
    assert tel.counters()["moe.routed"] == \
        2 * 16 * cfg.moe.top_k * cfg.n_layers
    assert positions_k.positions.launches == launched


@pytest.mark.parametrize("case", ["int32", "two_dims", "no_experts",
                                  "too_many_experts", "on_the_cpu"])
def test_positions_kernel_refuses_before_any_launch(case):
    top_e = torch.zeros((2, 8, 6), dtype=torch.int64)
    e = 64
    if case == "int32":
        top_e, err, match = top_e.int(), TypeError, "int64"
    elif case == "two_dims":
        top_e, err, match = top_e[0], ValueError, r"\(B, S, k\)"
    elif case == "no_experts":
        e, err, match = 0, ValueError, "experts"
    elif case == "too_many_experts":
        e, err, match = positions_k.MAX_EXPERTS + 1, ValueError, "experts"
    else:
        err, match = ValueError, "CUDA"
    launched = positions_k.positions.launches
    with pytest.raises(err, match=match):
        positions_k.positions(top_e, e, 4)
    assert positions_k.positions.launches == launched


@pytest.mark.parametrize("n,threads", [(1, 32), (6, 32), (256, 32),
                                       (257, 64), (6144, 768),
                                       (24576, 1024), (49152, 1024)])
def test_a_group_s_block_follows_its_length(n, threads):
    """One thread for each 8 choices of a group, in whole warps, at most
    1,024: a decode group of k choices takes one warp, the prefill cell's
    groups of 6,144 one block of 768 threads each, the train cells'
    groups 3 and 6 blocks of 1,024."""
    assert positions_k.threads_for(n) == threads
