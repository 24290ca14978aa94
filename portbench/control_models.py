"""The controls and planted faults of the model cells that ``control.py``
does not cover (``serve_prefill`` and ``train_step_mla``), read at a
cell's own size on the card (the tests read them at a size the CPU
holds).

    python3 portbench/control_models.py --workload <name> --seeds <n> [<n> ...]
        [--faults <fault> ...]

prints one JSON line a seed: the numbers the cell compares for its
control, for each planted fault (``--faults``: those named, by default
all) and for the program itself. The control is the plain reference
computed with float8 products, the step below the bfloat16 the
configuration computes in. The faults are planted in the program: for
the prefill cell, caches left unwritten by prefill (in every slot, or in
the last slot alone), half of each batch's prompts replaced by the other
half's, the routed experts' weights halved, and the last position's
logits taken from the first position; for the train cell,
``control.py``'s (half of each batch's labels left out, one leaf's
gradient doubled), a state left unchanged by the optimizer, and routers
whose bias never moves or moves against the loads. The train cell's line
also holds ``bias_look``: where the program's balancing signs differ
from the reference's, and how far those experts' loads lie from the mean.
"""
from __future__ import annotations

import contextlib
import functools
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import control, harness, inputs  # noqa: E402
from portbench.reference import mla_moe_lm, moe_lm  # noqa: E402


@contextlib.contextmanager
def planted(owner, attr: str, make):
    """``owner.attr`` replaced by ``make(original)`` inside the block."""
    orig = getattr(owner, attr)
    setattr(owner, attr, make(orig))
    try:
        yield
    finally:
        setattr(owner, attr, orig)


def stale_cache():
    """Prefill leaves every cache entry as it was made: zeros."""
    def make(orig):
        def prefill(*args, **kw):
            x, aux, cache = orig(*args, **kw)
            for v in cache.values():
                v.zero_()
            return x, aux, cache
        return prefill
    from repro_torch.models import model

    return planted(model, "block_prefill", make)


def one_slot_cache():
    """Prefill leaves the last slot's cache entries as they were made."""
    def make(orig):
        def prefill(*args, **kw):
            x, aux, cache = orig(*args, **kw)
            for v in cache.values():
                v[-1].zero_()
            return x, aux, cache
        return prefill
    from repro_torch.models import model

    return planted(model, "block_prefill", make)


def first_position():
    """The last-position prefill returns the first position's logits."""
    def make(orig):
        @functools.wraps(orig)
        def prefill(self, tokens, *args, all_positions=False, **kw):
            logits, caches = orig(self, tokens, *args, all_positions=True,
                                  **kw)
            return (logits if all_positions else logits[:, :1]), caches
        return prefill
    from repro_torch.models.model import LM

    return planted(LM, "prefill", make)


def half_prompts():
    """The second half of each batch's prompts replaced by the first's."""
    def make(orig):
        @functools.wraps(orig)
        def prefill(self, tokens, *args, **kw):
            tokens = tokens.clone()
            half = tokens.shape[0] // 2
            tokens[half:2 * half] = tokens[:half]
            return orig(self, tokens, *args, **kw)
        return prefill
    from repro_torch.models.model import LM

    return planted(LM, "prefill", make)


def routed_halved():
    """The routed experts' weights halved (a wrong routed scale)."""
    def make(orig):
        def routing(logits, mc):
            w, e, aux = orig(logits, mc)
            return w * 0.5, e, aux
        return routing
    from repro_torch.models import moe

    return planted(moe, "_routing", make)


PREFILL_FAULTS = {"stale_cache": stale_cache, "one_slot_cache": one_slot_cache,
                  "half_batch": half_prompts, "altered_answer": routed_halved,
                  "first_position": first_position}


def unchanged_state():
    """The optimizer changes nothing."""
    from repro_torch.optim.adamw import AdamW

    return planted(AdamW, "step", lambda orig: (
        lambda self, grads, state, params: (params, state)))


def stale_bias():
    """No router's bias ever moves."""
    from repro_torch.models.model import LM

    return planted(LM, "update_router_bias",
                   lambda orig: (lambda self: None))


def reversed_bias():
    """Every router's bias moves against its loads."""
    def make(orig):
        def update(self):
            before = [p["router_bias"].clone() for p in self.routers()]
            orig(self)
            for p, b in zip(self.routers(), before):
                p["router_bias"].copy_(2 * b - p["router_bias"])
        return update
    from repro_torch.models.model import LM

    return planted(LM, "update_router_bias", make)


def half_labels():
    """``control.half_labels`` under the program's loss."""
    from repro_torch.models.model import LM

    return planted(LM, "loss", lambda orig: (
        lambda self, batch, **kw: orig(self, control.half_labels(batch),
                                       **kw)))


TRAIN_FAULTS = {"stale_state": unchanged_state, "half_batch": half_labels,
                "altered_answer": lambda: control.doubled_gradient(
                    "decoder.1.mlp.experts.wi"),
                "stale_bias": stale_bias, "reversed_bias": reversed_bias}


def prefill_readings(ctx: harness.Context, seed: int, device,
                     faults=PREFILL_FAULTS) -> dict:
    """The prefill cell's readings for the control, each fault and the
    program, each against the float32 reference."""
    import torch

    drv = harness.load_module(ctx.cell.folder / "drivers" /
                              "serve_prefill.py", "portbench_driver_prefill")
    c, t = ctx.config, ctx.traffic
    s = moe_lm.sizes(c)
    shapes = moe_lm.leaf_shapes(s)
    scales = moe_lm.leaf_scales(shapes)

    def program() -> dict:
        model = drv.program(ctx, s, shapes, scales, device)
        stream = inputs.TokenStream(seed, t["batch"], t["seq"], s["vocab"],
                                    device)
        got = drv.checked_batches(model, stream, t)
        del model
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        return got

    got = program()
    want = drv.reference(got, c, t, shapes, scales, seed, device)
    out = {"seed": seed, "control": drv.readings(drv.reference(
        got, c, t, shapes, scales, seed, device, precision="fp8"), want)}
    for name, fault in faults.items():
        with fault():
            out[name] = drv.readings(program(), want)
    out["program"] = drv.readings(got, want)
    # The look: the program's position gaps by quantile, and each
    # decoded token's.
    gaps = drv.position_gaps(got["logits"], want["logits"])
    out["program_gap_quantiles"] = {
        q: float(gaps.quantile(q)) for q in (0.5, 0.9, 0.99, 1.0)}
    out["program_decode_gaps"] = drv.slot_gaps(got["decode"],
                                                want["decode"]).tolist()
    out["program_last_gaps"] = drv.position_gaps(got["last"],
                                                 want["last"]).tolist()
    return out


@contextlib.contextmanager
def loads_seen(prog_loads: list, ref_loads: list):
    """Inside the block, each train step's loads (a list of each MoE
    layer's (E,) loads, on the host) as the program's bias update and the
    reference's read them."""
    from repro_torch.models.model import LM

    def program(orig):
        def update(self):
            prog_loads.append([p["router_load"].double().cpu()
                               for p in self.routers()])
            orig(self)
        return update

    def reference(orig):
        def update(biases, loads, s):
            ref_loads.append([loads[i].double().cpu()
                              for i in sorted(biases)])
            orig(biases, loads, s)
        return update

    with planted(LM, "update_router_bias", program), \
            planted(mla_moe_lm, "update_biases", reference):
        yield


def bias_look(prog_loads: list, ref_loads: list) -> dict:
    """Where the program's sign(mean load - load) differs from the
    reference's (steps x layers x experts), how far from its mean the
    reference's load lay at each such sign, against every expert's; and
    how far the program's loads lie from the reference's."""
    import torch

    flips, near, gaps, off = 0, [], [], []
    for got, want in zip(prog_loads, ref_loads):
        for g, w in zip(got, want):
            d = (w - w.mean()).abs()
            flip = torch.sign(g.mean() - g) != torch.sign(w.mean() - w)
            flips += int(flip.sum())
            near += d[flip].tolist()
            gaps += d.tolist()
            off += (g - w).abs().tolist()
    gaps_t, off_t = torch.tensor(gaps), torch.tensor(off)
    far = max(near, default=0.0)
    return {"signs": len(gaps), "flipped": flips,
            "flipped_distance": sorted(near),
            "distance_quantiles": {q: float(gaps_t.quantile(q))
                                   for q in (0.1, 0.25, 0.5, 0.9)},
            "share_within_flipped": float((gaps_t <= far).double().mean()),
            "load_gap_quantiles": {q: float(off_t.quantile(q))
                                   for q in (0.5, 0.9, 1.0)}}


def train_readings(ctx: harness.Context, seed: int, device,
                   faults=TRAIN_FAULTS) -> dict:
    """The latent-attention train cell's readings for the control, each
    fault and the program, each against the float32 reference; and
    ``bias_look`` of the program's checked steps."""
    import torch

    drv = harness.load_module(ctx.cell.folder / "drivers" /
                              "train_step_mla.py", "portbench_driver_mla")
    t = ctx.traffic
    s = mla_moe_lm.sizes(ctx.config)
    shapes = mla_moe_lm.leaf_shapes(s)
    scales = mla_moe_lm.leaf_scales(shapes)
    prog_loads: list = []
    ref_loads: list = []
    with loads_seen([], ref_loads):
        want = drv.check_steps(ctx, seed, s, shapes, scales, device)
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    out = {"seed": seed, "control": drv.readings(drv.check_steps(
        ctx, seed, s, shapes, scales, device, precision="fp8"), want)}

    def program() -> dict:
        prog = drv.Program(ctx, shapes, scales, seed, device)
        stream = inputs.TokenStream(seed, t["batch"], t["seq"], s["vocab"],
                                    device)
        got = drv.checked(prog, ctx, stream, shapes, scales, seed, device)
        del prog
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        return got

    for name, fault in faults.items():
        with fault():
            out[name] = drv.readings(program(), want)
    with loads_seen(prog_loads, []):
        got = program()
    out["program"] = drv.readings(got, want)
    out["losses"] = {"program": got["losses"], "reference": want["losses"]}
    out["bias_look"] = bias_look(prog_loads, ref_loads)
    return out


READERS = {"serve_prefill": prefill_readings,
           "train_step_mla": train_readings}


def main(argv: list[str] | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--faults", nargs="*", default=None,
                    help="the faults to plant (default: every one)")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(harness.program_path()))
    cell = harness.load_cell(args.workload)
    reader = READERS[cell.traffic["driver"]]
    every = {"serve_prefill": PREFILL_FAULTS,
             "train_step_mla": TRAIN_FAULTS}[cell.traffic["driver"]]
    faults = every if args.faults is None else \
        {k: every[k] for k in args.faults}
    for seed in args.seeds:
        ctx = harness.Context(cell, seed, 0.0, False)
        print(json.dumps(reader(ctx, seed, "cuda", faults=faults)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
