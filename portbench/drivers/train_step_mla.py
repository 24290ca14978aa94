"""A DeepSeek-V3-style language model's train step (latent attention, a
sigmoid router with a balancing bias, leading dense layers), steps back
to back.

As ``train_step.py``, whose helpers it takes: set-up builds one train
step of the port (``LM`` with the configuration's sizes,
``make_train_step`` under the same AdamW) and hands it the benchmark's
weights, drawn on the device from the seed in one call; every router's
bias starts at 0. It drives that step through its first
``checked_steps`` steps on batches from the seed and keeps each step's
loss, each leaf's norm of the first gradient, each leaf's norm of its
change and, here, each router's bias after the last. The window then
runs further steps back to back until ``ctx.seconds`` have passed. A
traced run profiles ``trace_steps`` more, each under a telemetry
registry of its own: the device time of its ``attn.mla`` spans and the
MoE layers' ``moe.load_max`` and ``moe.routed`` counters.

After the window the program's state is freed and the plain reference
(``reference/mla_moe_lm.py``, float32) runs the checked steps from the
same weights on the same batches. The numbers compared are
``train_step.py``'s (``loss_gap``, ``grad_norm_gap``,
``grad_median_gap``, ``change_norm_gap``) and ``bias_gap`` (||b -
b_ref|| / ||b_ref|| over every router), each where the traffic gives its
limit; the others are reported.

A sound ``bias_gap`` is not small. Each step moves every bias by the
rate times sign(mean load - load), and in bfloat16 a router near a tie
chooses another expert for some tokens, so the program's loads differ
from the reference's by a few tokens an expert: an expert whose load
lies that near the mean takes the other sign, and its bias then differs
by twice the rate, against a bias of one to three times the rate after
the checked steps. A bias that never moves reads 1, one that moves
against the loads about 2.
"""
from __future__ import annotations

import sys
import time
import traceback
from pathlib import Path

import torch

from portbench import gpu, inputs
from portbench.harness import Context, HarnessError, Outcome, load_module
from portbench.reference import mla_moe_lm as ref

# train_step.py beside this file: its optimizer, step checks and readings.
base = load_module(Path(__file__).with_name("train_step.py"),
                   "portbench_driver_train_step")

NEEDS = {"moe_layer_freq": 1, "norm_topk_prob": True,
         "scoring_func": "sigmoid", "topk_method": "noaux_tc", "n_group": 1,
         "topk_group": 1, "seq_aux": True, "hidden_act": "silu",
         "tie_word_embeddings": False, "attention_bias": False,
         "q_lora_rank": None, "num_nextn_predict_layers": 0}


def port_config(c: dict):
    """The port's ModelConfig of a configuration file, refused where the
    file states what the port cannot run."""
    try:
        from repro_torch.models.config import (MlaConfig, ModelConfig,
                                               MoeConfig)
    except ImportError as e:
        raise HarnessError(f"the port has no latent attention: {e}")
    wrong = {k: c[k] for k, v in NEEDS.items() if c[k] != v}
    if wrong:
        raise HarnessError(f"the port cannot run {wrong}")
    a = c["assumed"]
    return ModelConfig(
        name=c["name"], family="moe", n_layers=c["num_hidden_layers"],
        d_model=c["hidden_size"], n_heads=c["num_attention_heads"],
        n_kv_heads=c["num_key_value_heads"], d_ff=c["intermediate_size"],
        vocab=c["vocab_size"], mlp="swiglu", rope_theta=c["rope_theta"],
        rms_eps=c["rms_norm_eps"], first_k_dense=c["first_k_dense_replace"],
        mla=MlaConfig(kv_lora_rank=c["kv_lora_rank"],
                      qk_nope_head_dim=c["qk_nope_head_dim"],
                      qk_rope_head_dim=c["qk_rope_head_dim"],
                      v_head_dim=c["v_head_dim"]),
        moe=MoeConfig(n_experts=c["n_routed_experts"],
                      top_k=c["num_experts_per_tok"],
                      n_shared=c["n_shared_experts"],
                      d_expert=c["moe_intermediate_size"],
                      capacity_factor=a["capacity_factor"],
                      dispatch=a["dispatch"],
                      router_aux_weight=a["aux_loss_alpha"],
                      scoring="sigmoid",
                      routed_scale=c["routed_scaling_factor"],
                      bias_rate=a["bias_update_rate"]),
        dtype="bfloat16", param_dtype="float32", remat=True,
        z_loss=a["z_loss"])


class Program:
    """The port's model and train step with the benchmark's weights."""

    def __init__(self, ctx: Context, shapes: dict, scales: dict, seed: int,
                 device, marks=None):
        from repro_torch.models.model import LM
        from repro_torch.optim.adamw import AdamW, warmup_cosine
        from repro_torch.train.step import make_train_step

        o = base.OPTIMIZER
        self.model = LM(port_config(ctx.config), device=device, seed=0)
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

    def biases(self) -> torch.Tensor:
        """Every router's bias, layer after layer, on the host."""
        return torch.cat([p["router_bias"].detach().cpu()
                          for p in self.model.routers()])


def bias_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """||got - want|| / ||want|| (infinite where got is not finite)."""
    if not bool(torch.isfinite(got).all()):
        return float("inf")
    got, want = got.double(), want.double()
    return float(torch.linalg.vector_norm(got - want) /
                 torch.linalg.vector_norm(want).clamp_min(1e-300))


def checked(prog: Program, ctx: Context, stream, shapes: dict,
            scales: dict, seed: int, device, batch_hook=None) -> dict:
    """``train_step.checked_steps`` of this program, with its biases."""
    got = base.checked_steps(prog, stream, ctx.traffic, shapes, scales,
                             seed, device, batch_hook)
    got["biases"] = prog.biases()
    return got


def check_steps(ctx: Context, seed: int, s: dict, shapes: dict,
                scales: dict, device, precision: str = "float32") -> dict:
    """The reference's checked steps from the seed's weights on the
    seed's batches: losses, first-gradient norms, change norms, and the
    routers' biases after them."""
    t = ctx.traffic
    stream = inputs.TokenStream(seed, t["batch"], t["seq"], s["vocab"],
                                device)
    batches = [stream.next() for _ in range(t["checked_steps"])]
    _, params = inputs.draw_weights(shapes, scales, seed, device)
    biases = ref.initial_biases(s, device)
    out = ref.train_steps(params, biases, batches, s, base.OPTIMIZER,
                          precision)
    _, start = inputs.draw_weights(shapes, scales, seed, device)
    out["changes"] = base.change_norms(params, start)
    out["biases"] = torch.cat([biases[i].cpu() for i in sorted(biases)])
    return out


def readings(got: dict, want: dict) -> dict[str, float]:
    """``train_step.readings`` and ``bias_gap``."""
    out = base.readings(got, want)
    out["bias_gap"] = bias_gap(got["biases"], want["biases"])
    return out


def traced_steps(prog: Program, stream, n: int, device) -> dict:
    """``n`` steps, each under a telemetry registry of its own: the
    device ms of its ``attn.mla`` spans, and the summed ``moe.load_max``
    and ``moe.routed`` counters."""
    from repro_torch import obs

    ms, load_max, routed = [], 0.0, 0.0
    for _ in range(n):
        tel = obs.Telemetry()
        with obs.use(tel):
            prog(stream.next())
        gpu.sync(device)
        span = tel.spans_by_name().get("attn.mla") or {}
        if span.get("device_s") is not None:
            ms.append(1e3 * span["device_s"])
        counts = tel.counters()
        load_max += counts.get("moe.load_max", 0.0)
        routed += counts.get("moe.routed", 0.0)
    return {"mla_fwd_ms": ms,
            "moe_load": {"load_max": load_max, "routed": routed,
                         "experts": prog.model.cfg.moe.n_experts}}


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
    prog = Program(ctx, shapes, scales, ctx.seed, dev,
                   marks=mark if ctx.trace else None)
    got = checked(prog, ctx, stream, shapes, scales, ctx.seed, dev)
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
                  mla_config={k: s[k] for k in (
                      "layers", "dense", "d_model", "heads", "q_nope",
                      "q_rope", "v_dim", "kv_rank", "d_ff", "vocab",
                      "d_expert", "experts", "top_k", "shared")})
    outcome.attempted = steps + t["checked_steps"]
    outcome.failed = sum(not torch.isfinite(x).item() for x in window_losses)
    if ctx.trace and outcome.error is None:
        with gpu.Profile(dev) as trace:
            record.update(traced_steps(prog, stream, t["trace_steps"], dev))
        summary = gpu.summarize(trace["events"], trace["window_s"])
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
    want = check_steps(ctx, ctx.seed, s, shapes, scales, dev)
    for name, value in readings(got, want).items():
        # A reading without a limit is reported, not compared: its
        # control and faults read too close to sound runs (PERF.md).
        if f"{name}_limit" in t:
            outcome.checks[name] = (value, t[f"{name}_limit"])
        else:
            print(f"reading {name}: {value!r} (not compared)",
                  file=sys.stderr)
    return outcome
