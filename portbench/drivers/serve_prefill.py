"""A language model's prefill, batches back to back.

Set-up builds the port's model (``LM`` with the configuration's sizes,
the train cell's ``port_config``) and hands it the benchmark's weights,
drawn on the device from the seed in one call. The window then calls
``LM.prefill`` as ``serve/engine.py`` calls it, one batch of prompts
after another (token ids uniform over the vocabulary from the seed,
every batch new), each into a fresh cache of ``t_max`` positions, until
``ctx.seconds`` have passed, then drains the card; it counts the prompt
tokens and the batches whose logits are not all finite.

The check: before the window the seed's first ``checked_batches``
batches each run the prefill twice. Once exactly as the window calls it
(a cache of ``t_max`` positions, the last position's logits); once with
the logits at every position (``all_positions``) into caches
``DECODE_STEPS`` positions longer, through which the batch then decodes
``DECODE_STEPS`` tokens (``LM.decode_step``, the tokens drawn from the
seed). After the window the program's state is freed and the plain
reference (``reference/moe_prefill.py``, float32) computes each
sequence's forward over the prompt and those tokens (the prompt routed
with the prompt's capacity, the decoded tokens dropless, as prefill and
decode route them). Each position's gap is ||program - reference|| /
||reference|| over its logits. The numbers compared: ``logit_gap``, the
mean gap over every prompt position of the checked batches;
``last_gap``, the lower quartile of the gaps of the window's calls
(every prompt's last position); ``decode_gap``, the largest over the
batch's slots of the lower quartile of the slot's decoded tokens' gaps
(``checked_batches`` x ``DECODE_STEPS`` tokens a slot).

In bfloat16 a router near a tie may choose another expert for a token
(and a capacity's drops then move to other tokens), which moves that
position's logits by 0.05-0.15 where a sound one reads 0.01: about one
position in six on the card. The mean over thousands of prompt positions
counts them at their share; a lower quartile passes them by unless
three in four of the gaps it takes meet one, where a precision, a cache
or a path at fault moves every gap it touches: every last position on
the window's path, every decoded token of a slot whose cache or decode
is wrong.
"""
from __future__ import annotations

import inspect
import os
import sys
import time
import traceback
from pathlib import Path

import torch

from portbench import gpu, inputs
from portbench.harness import Context, HarnessError, Outcome, load_module
from portbench.reference import moe_lm as ref
from portbench.reference import moe_prefill

# The train cell's driver beside this file, for its port_config.
train_step = load_module(Path(__file__).with_name("train_step.py"),
                         "portbench_driver_train_step")

# The bf16 flash kernel's name in the profiler's trace.
FLASH_KERNEL = "flash_fwd_bf16_kernel"
# Tokens each checked batch decodes through the caches its prefill wrote.
DECODE_STEPS = 4


def program(ctx: Context, s: dict, shapes: dict, scales: dict, dev):
    """The port's model holding the benchmark's weights, for serving."""
    from repro_torch.models.model import LM

    if "all_positions" not in inspect.signature(LM.prefill).parameters:
        raise HarnessError("the port's LM.prefill cannot return the logits "
                           "at every position (all_positions)")
    model = LM(train_step.port_config(ctx.config), device=dev, seed=0)
    own = dict(model.named_parameters())
    got = {k: tuple(p.shape) for k, p in own.items()}
    if got != shapes:
        raise HarnessError("the port's parameters are not the reference's")
    flat, views = inputs.draw_weights(shapes, scales, ctx.seed, dev)
    with torch.no_grad():
        for k, p in own.items():
            p.copy_(views[k])
    del flat, views
    return model


def checked_batches(model, stream, t: dict) -> dict:
    """The program's checked prefills, on the host: each batch's prompts,
    the window's call's last-position logits (B, V), the logits at every
    position (B, S, V), the decoded tokens (B, DECODE_STEPS) and their
    logits (B, DECODE_STEPS, V)."""
    out: dict = {"prompts": [], "last": [], "logits": [], "next": [],
                 "decode": []}
    for _ in range(t["checked_batches"]):
        prompts = stream.next()["tokens"]
        nxt = stream.next()["tokens"][:, :DECODE_STEPS]
        last, _ = model.prefill(prompts, t["t_max"])
        logits, caches = model.prefill(prompts, t["seq"] + DECODE_STEPS,
                                       all_positions=True)
        steps = [model.decode_step(nxt[:, j:j + 1], t["seq"] + j,
                                   caches)[0][:, 0].cpu()
                 for j in range(DECODE_STEPS)]
        out["prompts"].append(prompts.cpu())
        out["last"].append(last[:, -1].cpu())
        out["logits"].append(logits.cpu())
        out["next"].append(nxt.cpu())
        out["decode"].append(torch.stack(steps, dim=1))
        del last, logits, caches, steps
    return out


def position_gaps(got: list, want: list) -> torch.Tensor:
    """Each position's ||got - want|| / ||want|| over its logits, in
    float32, a batch at a time (infinite where got is not finite or not
    want's shape)."""
    out = []
    for g, w in zip(got, want):
        if g.shape != w.shape:
            return torch.full((1,), float("inf"))
        g, w = g.reshape(-1, g.shape[-1]).float(), \
            w.reshape(-1, w.shape[-1]).float()
        gaps = torch.linalg.vector_norm(g - w, dim=-1) / \
            torch.linalg.vector_norm(w, dim=-1).clamp_min(1e-30)
        out.append(torch.where(torch.isfinite(g).all(-1), gaps,
                               float("inf")))
    return torch.cat(out)


def slot_gaps(got: list, want: list) -> torch.Tensor:
    """The decoded tokens' gaps by slot: (B, batches x steps), from
    batches of (B, steps, V) logits (infinite where the shapes differ)."""
    if [g.shape for g in got] != [w.shape for w in want]:
        return torch.full((1, 1), float("inf"))
    b, n = want[0].shape[:2]
    return position_gaps(got, want).reshape(len(want), b, n) \
        .transpose(0, 1).reshape(b, -1)


def readings(got: dict, want: dict) -> dict[str, float]:
    """``logit_gap``, the mean position gap over the prompts;
    ``last_gap``, the lower quartile of the window's calls' gaps;
    ``decode_gap``, the largest over the slots of the lower quartile of
    a slot's decoded tokens' gaps."""
    return {"logit_gap": float(position_gaps(got["logits"],
                                             want["logits"]).mean()),
            "last_gap": float(position_gaps(got["last"],
                                            want["last"]).quantile(0.25)),
            "decode_gap": float(slot_gaps(got["decode"], want["decode"])
                                .quantile(0.25, dim=1).max())}


def reference(got: dict, c: dict, t: dict, shapes: dict, scales: dict,
              seed: int, device, precision: str = "float32") -> dict:
    """The reference's logits of the checked prompts (B, S, V), of their
    last positions (B, V) and of their decoded tokens (B, DECODE_STEPS,
    V), from the seed's weights, a sequence (the prompt and its decoded
    tokens) at a time."""
    s = ref.sizes(c)
    _, params = inputs.draw_weights(shapes, scales, seed, device)
    v, n = got["logits"][0].shape[-1], t["seq"]
    out: dict = {"logits": [], "last": [], "decode": []}
    for prompts, nxt in zip(got["prompts"], got["next"]):
        seqs = torch.cat([prompts, nxt], dim=1).to(device)
        rows = torch.stack([moe_prefill.logits(params, seq, s, n, precision)
                            [:, :v].cpu() for seq in seqs])
        out["logits"].append(rows[:, :n])
        out["last"].append(rows[:, n - 1])
        out["decode"].append(rows[:, n:])
    return out


def timed(ctx: Context, model, stream, s: dict, outcome: Outcome) -> None:
    """The window and, traced, the profiled stretch, read into
    ``outcome``. Batches are launched back to back and the card drained
    once, at the window's end, as a prefill pool keeps its card fed: a
    wait for each batch would leave the card idle while the host starts
    the next."""
    t, record, dev = ctx.traffic, outcome.record, model.device
    batches, bad = 0, []
    t0 = time.perf_counter()
    deadline = t0 + ctx.seconds
    try:
        while time.perf_counter() < deadline:
            logits, _ = model.prefill(stream.next()["tokens"], t["t_max"])
            bad.append(~torch.isfinite(logits).all())
            batches += 1
        gpu.sync(dev)
    except Exception:  # the window's failure is the run's result
        outcome.error = traceback.format_exc()
    record.update(window_s=time.perf_counter() - t0, batches=batches,
                  tokens=batches * t["batch"] * t["seq"],
                  batch=t["batch"], seq=t["seq"],
                  flops_config={k: s[k] for k in (
                      "layers", "d_model", "heads", "kv_heads", "head_dim",
                      "vocab", "d_expert", "experts", "top_k", "shared")})
    outcome.attempted = batches + t["checked_batches"]
    outcome.failed = int(sum(int(b) for b in bad))
    if not ctx.trace or outcome.error is not None:
        return
    with gpu.Profile(dev) as trace:
        for _ in range(t["trace_batches"]):
            model.prefill(stream.next()["tokens"], t["t_max"])
    summary = gpu.summarize(trace["events"], trace["window_s"])
    record["stretch"] = {"busy_s": summary["busy_s"],
                         "window_s": summary["window_s"]}
    flash = [e for e in gpu.device_events(trace["events"])
             if FLASH_KERNEL in e["name"]]
    record["flash"] = {"launches": len(flash),
                       "device_s": sum(e["dur"] for e in flash) / 1e6,
                       "batch": t["batch"], "heads": s["heads"],
                       "kv_heads": s["kv_heads"], "seq": t["seq"],
                       "head_dim": s["head_dim"]}
    outcome.breakdown = summary["breakdown"]


def run(ctx: Context) -> Outcome:
    t_setup = time.perf_counter()
    dev = torch.device("cuda") if ctx.device is None else \
        torch.device(ctx.device)
    c, t = ctx.config, ctx.traffic
    s = ref.sizes(c)
    shapes = ref.leaf_shapes(s)
    scales = ref.leaf_scales(shapes)
    outcome = Outcome()
    model = program(ctx, s, shapes, scales, dev)
    stream = inputs.TokenStream(ctx.seed, t["batch"], t["seq"], s["vocab"],
                                dev)
    got = checked_batches(model, stream, t)
    # The checks end in decode steps: the window starts from the state its
    # own call leaves.
    model.prefill(stream.next()["tokens"], t["t_max"])
    gpu.sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    outcome.record["setup_s"] = time.perf_counter() - t_setup
    print(f"setup {outcome.record['setup_s']:.2f} s", file=sys.stderr)

    # The host launches a batch in 13-23 ms against the card's 23 ms, so the
    # rate is bounded by the host's issue: moved between CPUs it launches
    # slower and the rate follows. The process keeps to one CPU while it is
    # timed, as a serving container holds exclusive CPUs under Kubernetes'
    # static CPU manager policy (PERF.md).
    cpus = os.sched_getaffinity(0)
    os.sched_setaffinity(0, {max(cpus)})
    try:
        timed(ctx, model, stream, s, outcome)
    finally:
        os.sched_setaffinity(0, cpus)
    outcome.device = gpu.device_record(dev)
    if "stretch" in outcome.record:
        outcome.device.update(outcome.record["stretch"])

    # The reference, once the program's state is freed.
    del model
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    want = reference(got, c, t, shapes, scales, ctx.seed, dev)
    for name, value in readings(got, want).items():
        outcome.checks[name] = (value, t[f"{name}_limit"])
    return outcome
