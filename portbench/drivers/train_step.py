"""A language model's train step, steps back to back.

Set-up builds one train step of the port (``LM`` with the
configuration's sizes, ``make_train_step`` under AdamW) and hands it the
benchmark's weights, drawn on the device from the seed in one call. It
drives that same step through its first ``checked_steps`` steps on
batches from the seed (token ids uniform over the vocabulary, a new row
every time) and keeps, for the check, each step's loss, each leaf's norm
of the first gradient as AdamW took it (its first moment over 1 - b1)
and, after the last, each leaf's norm of its change since the start.
The window then runs further steps back to back, one batch each, until
``ctx.seconds`` have passed.

After the window the program's state is freed and the plain reference
(``reference/moe_lm.py``) runs the checked steps from the same weights
on the same batches. The numbers compared: the largest gap of a step's
loss, as a share of the reference's; and for the first gradient and for
the change, by the worst leaf, the gap between the program's norm and
the reference's as a share of the larger of the reference's norm of that
leaf and of the median leaf. The change leaves out leaves whose first
gradient in the reference is under a thousandth of the median leaf's.
"""
from __future__ import annotations

import statistics
import sys
import time
import traceback

import torch

from portbench import gpu, inputs
from portbench.harness import Context, HarnessError, Outcome
from portbench.reference import moe_lm as ref


def port_config(c: dict):
    """The port's ModelConfig of a configuration file, refused where the
    file states what the port cannot run."""
    from repro_torch.models.config import ModelConfig, MoeConfig

    a = c["assumed"]
    needs = {"first_k_dense_replace": 0, "moe_layer_freq": 1,
             "norm_topk_prob": True, "scoring_func": "softmax",
             "hidden_act": "silu", "tie_word_embeddings": False,
             "attention_bias": False}
    wrong = {k: c[k] for k, v in needs.items() if c[k] != v}
    if wrong:
        raise HarnessError(f"the port cannot run {wrong}")
    return ModelConfig(
        name=c["name"], family="moe", n_layers=c["num_hidden_layers"],
        d_model=c["hidden_size"], n_heads=c["num_attention_heads"],
        n_kv_heads=c["num_key_value_heads"],
        d_ff=c["moe_intermediate_size"], vocab=c["vocab_size"],
        mlp="swiglu", rope_theta=c["rope_theta"], rms_eps=c["rms_norm_eps"],
        moe=MoeConfig(n_experts=c["n_routed_experts"],
                      top_k=c["num_experts_per_tok"],
                      n_shared=c["n_shared_experts"],
                      d_expert=c["moe_intermediate_size"],
                      capacity_factor=a["capacity_factor"],
                      dispatch=a["dispatch"],
                      router_aux_weight=c["aux_loss_alpha"]),
        dtype="bfloat16", param_dtype="float32", remat=True,
        z_loss=a["z_loss"])


OPTIMIZER = {"peak_lr": 3e-3, "warmup": 20, "total": 200, "final_frac": 0.1,
             "b1": 0.9, "b2": 0.95, "eps": 1e-8, "weight_decay": 0.1,
             "clip": 1.0}


@torch.no_grad()
def norms_of(tensors: dict) -> dict[str, float]:
    return {k: float(torch.linalg.vector_norm(t.double()))
            for k, t in tensors.items()}


@torch.no_grad()
def change_norms(params: dict, start: dict) -> dict[str, float]:
    return {k: float(torch.linalg.vector_norm((p - start[k]).double()))
            for k, p in params.items()}


def leaf_gaps(got: dict, want: dict, keep=None) -> dict[str, float]:
    """Each leaf's |got - want| / max(want, the median leaf's want)."""
    names = [k for k in want if keep is None or keep(k)]
    med = statistics.median(want[k] for k in names)
    return {k: abs(got[k] - want[k]) / max(want[k], med, 1e-30)
            for k in names}


def worst_leaf_gap(got: dict, want: dict, keep=None) -> float:
    return max(leaf_gaps(got, want, keep).values())


class Program:
    """The port's model and train step with the benchmark's weights."""

    def __init__(self, c: dict, shapes: dict, scales: dict, seed: int,
                 device, marks=None):
        from repro_torch.models.model import LM
        from repro_torch.optim.adamw import AdamW, warmup_cosine
        from repro_torch.train.step import make_train_step

        o = OPTIMIZER
        self.model = LM(port_config(c), device=device, seed=0)
        own = dict(self.model.named_parameters())
        got = {k: tuple(p.shape) for k, p in own.items()}
        if got != shapes:
            raise HarnessError(
                "the port's parameters are not the reference's: " + str(
                    sorted(k for k in set(got) | set(shapes)
                           if got.get(k) != shapes.get(k))))
        flat, views = inputs.draw_weights(shapes, scales, seed, device)
        with torch.no_grad():
            for k, p in own.items():
                p.copy_(views[k])
        del flat, views
        self.opt = AdamW(learning_rate=warmup_cosine(
            o["peak_lr"], o["warmup"], o["total"], o["final_frac"]),
            b1=o["b1"], b2=o["b2"], eps=o["eps"],
            weight_decay=o["weight_decay"], grad_clip_norm=o["clip"])
        self.step = make_train_step(self.model, self.opt, marks=marks)
        self.params = own
        self.state = self.opt.init(own)

    def __call__(self, batch: dict) -> torch.Tensor:
        self.params, self.state, met = self.step(self.params, self.state,
                                                 batch)
        return met["loss"]


def run(ctx: Context) -> Outcome:
    t_setup = time.perf_counter()
    dev = torch.device("cuda") if ctx.device is None else \
        torch.device(ctx.device)
    c, t = ctx.config, ctx.traffic
    s = ref.sizes(c)
    shapes = ref.leaf_shapes(s)
    scales = ref.leaf_scales(shapes)
    events: list = []

    def mark(name: str) -> None:
        if dev.type == "cuda":
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            events.append((name, e))

    outcome = Outcome()
    record = outcome.record
    stream = inputs.TokenStream(ctx.seed, t["batch"], t["seq"], s["vocab"],
                                dev)
    prog = Program(c, shapes, scales, ctx.seed, dev,
                   marks=mark if ctx.trace else None)
    checked = checked_steps(prog, stream, t, shapes, scales, ctx.seed, dev)
    events.clear()
    gpu.sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    record["setup_s"] = time.perf_counter() - t_setup
    print(f"setup {record['setup_s']:.2f} s", file=sys.stderr)

    steps, window_losses = 0, []
    parts = {"fwd_bwd": [], "opt": []}
    t0 = time.perf_counter()
    deadline = t0 + ctx.seconds
    try:
        while time.perf_counter() < deadline:
            if ctx.trace:
                events.clear()
                mark("start")
            window_losses.append(prog(stream.next()))
            gpu.sync(dev)
            steps += 1
            if ctx.trace and dev.type == "cuda":
                at = dict(events)
                parts["fwd_bwd"].append(at["start"].elapsed_time(
                    at["backward"]))
                parts["opt"].append(at["backward"].elapsed_time(
                    at["optimizer"]))
    except Exception:  # the window's failure is the run's result
        outcome.error = traceback.format_exc()
    record.update(window_s=time.perf_counter() - t0, steps=steps,
                  tokens=steps * t["batch"] * t["seq"],
                  batch=t["batch"], seq=t["seq"], parts=parts,
                  flops_config={k: s[k] for k in (
                      "layers", "d_model", "heads", "kv_heads", "head_dim",
                      "vocab", "d_expert", "experts", "top_k", "shared")})
    outcome.attempted = steps + t["checked_steps"]
    outcome.failed = sum(not torch.isfinite(x).item() for x in window_losses)
    if ctx.trace and outcome.error is None:
        with gpu.Profile(dev) as got:
            for _ in range(t["trace_steps"]):
                prog(stream.next())
        summary = gpu.summarize(got["events"], got["window_s"])
        record["stretch"] = {"busy_s": summary["busy_s"],
                             "window_s": summary["window_s"]}
        outcome.breakdown = summary["breakdown"]
    outcome.device = gpu.device_record(dev)
    if "stretch" in record:
        outcome.device.update(record["stretch"])

    # The reference, once the program's state is freed.
    del prog, window_losses
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    want = check_steps(ctx.seed, t, s, shapes, scales, dev)
    for name, value in readings(checked, want).items():
        # A reading without a limit is reported, not compared: its
        # control and faults read too close to sound runs (PERF.md).
        if f"{name}_limit" in t:
            outcome.checks[name] = (value, t[f"{name}_limit"])
        else:
            print(f"reading {name}: {value!r} (not compared)",
                  file=sys.stderr)
    return outcome


def checked_steps(prog: Program, stream, t: dict, shapes: dict,
                  scales: dict, seed: int, device, batch_hook=None) -> dict:
    """The program's first steps, as the reference will take them: each
    step's loss, each leaf's norm of the first gradient as AdamW took
    it (its first moment over 1 - b1), each leaf's norm of its change
    since the start. ``batch_hook`` plants a fault in what the program
    is fed (the tests and the controls)."""
    losses, grad_norms = [], None
    for i in range(t["checked_steps"]):
        batch = stream.next()
        losses.append(float(prog(batch if batch_hook is None
                                 else batch_hook(batch))))
        if i == 0:
            grad_norms = {k: v / (1 - OPTIMIZER["b1"])
                          for k, v in norms_of(prog.state["mu"]).items()}
    _, start = inputs.draw_weights(shapes, scales, seed, device)
    return {"losses": losses, "grad_norms": grad_norms,
            "changes": change_norms(prog.params, start)}


def readings(got: dict, want: dict) -> dict[str, float]:
    """The numbers compared: the largest gap of a step's loss as a share
    of the reference's; the worst and the median leaf's gap of the
    first gradient's norm; the worst leaf's gap of the change's norm
    (leaves whose reference gradient is under a thousandth of the median
    leaf's left out of the change)."""
    med = statistics.median(want["grad_norms"].values())
    grads = leaf_gaps(got["grad_norms"], want["grad_norms"])
    return {
        "loss_gap": max(abs(a - b) / abs(b)
                        for a, b in zip(got["losses"], want["losses"])),
        "grad_norm_gap": max(grads.values()),
        "grad_median_gap": statistics.median(grads.values()),
        "change_norm_gap": worst_leaf_gap(
            got["changes"], want["changes"],
            lambda k: want["grad_norms"][k] >= 1e-3 * med)}


def check_steps(seed: int, t: dict, s: dict, shapes: dict, scales: dict,
                device, precision: str = "float32") -> dict:
    """The reference's checked steps from the seed's weights on the
    seed's batches: losses, first-gradient norms, change norms."""
    stream = inputs.TokenStream(seed, t["batch"], t["seq"], s["vocab"],
                                device)
    batches = [stream.next() for _ in range(t["checked_steps"])]
    _, params = inputs.draw_weights(shapes, scales, seed, device)
    out = ref.train_steps(params, batches, s, OPTIMIZER, precision)
    _, start = inputs.draw_weights(shapes, scales, seed, device)
    out["changes"] = change_norms(params, start)
    return out
