"""The port's training path (``repro_torch.optim``, ``LM.loss``,
``repro_torch.train``) against the JAX package's, on the CPU, with the
reference's weights carried across (``models/convert.py``) and batches
from the reference's pipeline.

Tolerances:
- AdamW: 1e-6 of max |reference| after 5 steps on identical gradients;
  warmup_cosine at steps 0..100 within 1e-6 relative.
- loss: 1e-5 relative in float32 activations, 2e-2 in bfloat16.
- gradients, float32: max |port - reference| within 1e-3 of the
  reference's max |g| per parameter. The reduced configs under the
  reference's init (wq drawn at 1/sqrt(n_heads)) have attention scores
  of std ~30, so the gradient is ill-conditioned in q and k: a float64
  run whose q, k, v are perturbed by 2e-7 relative noise (about one
  float32 rounding) moves its gradients by 0.9e-4 to 4.8e-4 of max |g|
  (smollm-360m reduced, six draws), and the port's float32 projections
  (torch's sgemm, 3.6e-7 relative error against XLA's 1.9e-7) land at
  up to 5.2e-4 (wq, smollm-360m reduced) against the reference.
- gradients, bfloat16: ||port - reference|| within 0.3 of ||reference||
  per parameter (measured up to 0.135). The two round activations to
  bf16 in different places; the reference's own bf16 gradients are 28%
  to 167% from its float32 ones.
- one train step: parameters after it within 3e-3 absolute (Adam's
  sign normalisation turns reordered near-zero gradients into ±lr
  steps; tests/test_substrate.py's microbatch test uses the same). That
  bound passes a step that updates nothing (lr is 1e-3), and the clip
  rescales any gradient to norm 1, so the update (after - before) and
  AdamW's moments are held too, with and without the clip (without it
  mu and nu carry the gradient's scale, so a microbatch count divided
  wrongly shows). In float32 activations: ||update - reference's|| within
  5e-2 of ||reference's|| (measured up to 2.2e-2), mu and nu within 2e-3
  (up to 5.3e-4). In bfloat16, where reordered rounding flips the sign
  of many near-zero gradients: ||update|| within 10% of the reference's
  (0.997 to 1.033 of it), mu within 0.3 and nu within 0.6 of the
  reference's norm (up to 0.185 and 0.379).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced as r_get_reduced  # noqa: E402
from repro.data.pipeline import DataConfig, batch_for  # noqa: E402
from repro.models.model import LM as RLM  # noqa: E402
from repro.optim import adamw as radamw  # noqa: E402
from repro.train.step import make_train_step as r_make_train_step  # noqa: E402,E501
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.kernels.adamw import kernel as adamw_k  # noqa: E402
from repro_torch.kernels.adamw import ops as adamw_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ops import mha  # noqa: E402
from repro_torch.models.convert import params_from_jax, tree_from_jax  # noqa: E402,E501
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train.step import load_params, make_train_step  # noqa: E402,E501

ARCHS = ["smollm-360m", "granite-3-8b", "qwen2.5-32b"]


# -- AdamW -------------------------------------------------------------------

SHAPES = {"a": (7, 5), "b": (13,), "c": (3, 4, 2)}


def adam_case(master, clip, sched, seed=0):
    rng = np.random.default_rng(seed)
    p0 = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in SHAPES.items()}
    grads = [{k: (3 * rng.standard_normal(s)).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(5)]
    kw = dict(grad_clip_norm=clip, master_weights=master)
    ropt = radamw.AdamW(learning_rate=radamw.warmup_cosine(1e-2, 2, 5)
                        if sched else 1e-2, **kw)
    popt = adamw.AdamW(learning_rate=adamw.warmup_cosine(1e-2, 2, 5)
                       if sched else 1e-2, **kw)
    return p0, grads, ropt, popt


@pytest.mark.parametrize("sched", [False, True])
@pytest.mark.parametrize("clip", [None, 1.0])
@pytest.mark.parametrize("master", [False, True])
def test_adamw_matches_reference_over_five_steps(master, clip, sched):
    """bf16 parameters with master weights, float32 without; step (in
    place) and update + apply_updates (functional) both."""
    p0, grads, ropt, popt = adam_case(master, clip, sched)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if master else \
        (jnp.float32, torch.float32)
    rp = {k: jnp.asarray(v, jdt) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v).to(tdt) for k, v in p0.items()}
    up = {k: v.clone() for k, v in tp.items()}
    rs, ts, us = ropt.init(rp), popt.init(tp), popt.init(up)
    for g in grads:
        rp, rs = ropt.step({k: jnp.asarray(v, jdt) for k, v in g.items()},
                           rs, rp)
        tg = {k: torch.from_numpy(v).to(tdt) for k, v in g.items()}
        tp, ts = popt.step(tg, ts, tp)
        upd, us = popt.update(tg, us, up)
        up = {k: us["master"][k].to(tdt) for k in up} if master else \
            adamw.apply_updates(up, upd)
    assert int(ts["count"]) == int(us["count"]) == int(rs["count"]) == 5
    for k in SHAPES:
        ref = np.asarray(rp[k].astype(jnp.float32))
        for got in (tp[k], up[k]):
            assert got.dtype == tdt
            err = np.abs(got.float().numpy() - ref).max()
            assert err <= 1e-6 * np.abs(ref).max(), (k, err)
        for m in ("mu", "nu") + (("master",) if master else ()):
            ref = np.asarray(rs[m][k])
            err = np.abs(ts[m][k].numpy() - ref).max()
            assert err <= 1e-6 * np.abs(ref).max(), (m, k, err)


def test_warmup_cosine_matches_reference_over_100_steps():
    ref_s, got_s = radamw.warmup_cosine(3e-3, 20, 100), \
        adamw.warmup_cosine(3e-3, 20, 100)
    ref = np.array([float(ref_s(jnp.asarray(s))) for s in range(101)])
    got = np.array([float(got_s(torch.tensor(s))) for s in range(101)])
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)
    assert got[0] == 0.0 and got[20] == pytest.approx(3e-3)


def test_adamw_first_step_is_the_sign():
    """The reference's test_adamw_matches_reference_math on the port."""
    opt = adamw.AdamW(learning_rate=0.1, b1=0.9, b2=0.99, eps=1e-8,
                      weight_decay=0.0, grad_clip_norm=None)
    p = {"w": torch.tensor([1.0, -2.0])}
    g = {"w": torch.tensor([0.5, 0.25])}
    up, _ = opt.update(g, opt.init(p), p)
    expect = -0.1 * g["w"].numpy() / (np.abs(g["w"].numpy()) + 1e-8)
    np.testing.assert_allclose(up["w"].numpy(), expect, rtol=1e-5)


def test_adamw_weight_decay_decoupled_and_clip_bounds_norm():
    opt = adamw.AdamW(learning_rate=0.1, weight_decay=0.5,
                      grad_clip_norm=None)
    p = {"w": torch.tensor([2.0])}
    up, _ = opt.update({"w": torch.tensor([0.0])}, opt.init(p), p)
    np.testing.assert_allclose(up["w"].numpy(), [-0.1 * 0.5 * 2.0],
                               rtol=1e-5)
    opt = adamw.AdamW(grad_clip_norm=1.0)
    p = {"w": torch.ones(4)}
    _, st = opt.update({"w": torch.full((4,), 100.0)}, opt.init(p), p)
    assert float(adamw.global_norm(st["mu"])) <= 0.1 * 200.0 + 1e-3


def chained_step(opt, grads, state, params):
    """AdamW.step as the port ran it before kernels/adamw: the norm over
    the whole tree, then a chain of PyTorch ops a leaf."""
    count = state["count"] + 1
    c = count.float()
    scale = None
    if opt.grad_clip_norm is not None:
        gnorm = torch.sqrt(sum(torch.sum(torch.square(t.float()))
                               for t in grads.values()))
        scale = torch.clamp(opt.grad_clip_norm / gnorm.clamp_min(1e-9),
                            max=1.0)
    bc1, bc2, lr = 1 - opt.b1 ** c, 1 - opt.b2 ** c, opt._lr(count)
    master = state.get("master")
    for k, g in grads.items():
        p, mu, nu = params[k], state["mu"][k], state["nu"][k]
        g = g.float() if scale is None else g.float() * scale
        mu.mul_(opt.b1).add_(g, alpha=1 - opt.b1)
        nu.mul_(opt.b2).addcmul_(g, g, value=1 - opt.b2)
        anchor = p if master is None else master[k]
        den = (nu / bc2).sqrt_().add_(opt.eps)
        u = (mu / bc1).div_(den).add_(anchor.float(),
                                      alpha=opt.weight_decay).mul_(-lr)
        if master is None:
            p.add_(u.to(p.dtype))
        else:
            anchor.add_(u)
            p.copy_(anchor)
    state["count"] = count
    return params, state


@pytest.mark.parametrize("clip", [None, 1.0])
@pytest.mark.parametrize("pdt,master", [
    (torch.float32, False), (torch.float32, True), (torch.bfloat16, True)])
def test_adamw_plain_route_is_the_chained_step_bit_for_bit(pdt, master,
                                                           clip):
    """On the CPU AdamW.step takes kernels/adamw's plain version: five
    steps give the parameters, moments, master copies and count of the
    chain of ops it replaced, bit for bit."""
    p0, grads, _, popt = adam_case(master, clip, sched=True, seed=7)
    popt = dataclasses.replace(popt, weight_decay=0.3)
    tp = {k: torch.from_numpy(v).to(pdt) for k, v in p0.items()}
    cp = {k: v.clone() for k, v in tp.items()}
    ts, cs = popt.init(tp), popt.init(cp)
    for g in grads:
        tg = {k: torch.from_numpy(v).to(pdt) for k, v in g.items()}
        tp, ts = popt.step(tg, ts, tp)
        cp, cs = chained_step(popt, tg, cs, cp)
    assert torch.equal(ts["count"], cs["count"])
    for k in SHAPES:
        assert torch.equal(tp[k], cp[k]), k
        for m in ("mu", "nu") + (("master",) if master else ()):
            assert torch.equal(ts[m][k], cs[m][k]), (m, k)


@pytest.mark.parametrize("clip", [None, 1.0])
def test_adamw_launches_no_kernel_on_the_cpu(clip):
    """Off the card every element takes the plain route: two steps
    launch neither kernel, and each moves every parameter."""
    p0, grads, _, popt = adam_case(False, clip, sched=False)
    tp = {k: torch.from_numpy(v) for k, v in p0.items()}
    ts = popt.init(tp)
    launched = (adamw_k.sumsq.launches, adamw_k.update.launches)
    for g in grads[:2]:
        before = {k: v.clone() for k, v in tp.items()}
        popt.step({k: torch.from_numpy(v) for k, v in g.items()}, ts, tp)
        assert all(not torch.equal(tp[k], before[k]) for k in tp)
    assert (adamw_k.sumsq.launches, adamw_k.update.launches) == launched


@pytest.mark.parametrize("p,g,master", [
    ("float32", "float32", None), ("float32", "bfloat16", None),
    ("float32", "float32", "float32"), ("float32", "bfloat16", "float32"),
    ("bfloat16", "float32", "float32"), ("bfloat16", "bfloat16", "float32")])
def test_adamw_kernel_names_the_dtypes_it_takes(p, g, master):
    def t(name):
        return None if name is None else torch.zeros(2, dtype=getattr(
            torch, name))

    name = adamw_k.update_function(t(p), t(g), t(master))
    short = {"float32": "f32", "bfloat16": "bf16"}
    assert name == (f"adamw_update_p{short[p]}_g{short[g]}" +
                    ("_master" if master else ""))


@pytest.mark.parametrize("p,g,master", [
    ("bfloat16", "bfloat16", None), ("float16", "float16", "float32"),
    ("float32", "float16", None), ("float64", "float64", None),
    ("bfloat16", "bfloat16", "bfloat16"), ("float32", "float64", None)])
def test_adamw_kernel_refuses_other_dtypes_before_any_launch(p, g, master):
    """The combinations the kernel does not take raise in the wrapper's
    argument check, on CPU tensors, before it looks for a card."""
    def t(name):
        return None if name is None else torch.zeros(4, dtype=getattr(
            torch, name))

    pt, gt, mt = t(p), t(g), t(master)
    with pytest.raises(TypeError, match="adamw update"):
        adamw_k.update_function(pt, gt, mt)
    one = torch.ones(())
    with pytest.raises(TypeError, match="adamw update"):
        adamw_k.update(pt, gt, torch.zeros(4), torch.zeros(4), mt, None, one,
                       one, one, b1=0.9, b2=0.95, eps=1e-8,
                       weight_decay=0.1)
    if g not in ("float32", "bfloat16"):
        with pytest.raises(TypeError, match="adamw sumsq"):
            adamw_k.sumsq([gt])


def test_adamw_kernel_wants_card_tensors():
    """Dtypes it takes, on the CPU: refused for the device, not run."""
    one, z = torch.ones(()), torch.zeros(8)
    with pytest.raises(ValueError, match="CUDA"):
        adamw_k.update(z.clone(), z, z.clone(), z.clone(), None, None, one,
                       one, one, b1=0.9, b2=0.95, eps=1e-8,
                       weight_decay=0.1)
    with pytest.raises(ValueError, match="CUDA"):
        adamw_k.sumsq([z])


@pytest.mark.parametrize("dtype,width", [(torch.float32, 4),
                                         (torch.bfloat16, 8)])
@pytest.mark.parametrize("offset", range(9))
def test_adamw_kernel_split_aligns_every_array(dtype, width, offset):
    """The vector body starts where every array is 16-byte aligned; a
    set of arrays no head aligns goes element by element."""
    base = torch.zeros(64 + 16, dtype=torch.float32)
    n = 37
    a = base.to(dtype)[offset:offset + n]
    head, nvec = adamw_k._split(n, width, a)
    assert 0 <= head < width
    assert (a.data_ptr() + head * a.element_size()) % 16 == 0
    assert nvec == (n - head) // width
    f = torch.zeros(64, dtype=torch.float32)[offset:offset + n]
    g = torch.zeros(64, dtype=torch.float32)[offset + 1:offset + 1 + n]
    if (f.data_ptr() - g.data_ptr()) % 16:
        assert adamw_k._split(n, 4, f, g) == (n, 0)


# -- loss and gradients -----------------------------------------------------------

@functools.lru_cache(maxsize=None)
def jax_model(arch, dtype):
    m = RLM(dataclasses.replace(r_get_reduced(arch), dtype=dtype))
    return m, m.init(jax.random.PRNGKey(0))


def port_model(arch, dtype):
    jm, jp = jax_model(arch, dtype)
    m = LM(dataclasses.replace(get_reduced(arch), dtype=dtype), device="cpu")
    m.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jp), m))
    return m


def batch(arch, n=8, seq=16, packed=True):
    """The reference's batch and the same ids as tensors (packed: -1
    labels at document ends)."""
    cfg = r_get_reduced(arch)
    ref = batch_for(DataConfig(seq_len=seq, global_batch=n, vocab=cfg.vocab,
                               packed=packed, mean_doc_len=8), 0, cfg)
    return ref, {k: torch.from_numpy(np.array(v)) for k, v in ref.items()}


def to_f32(tree):
    return jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), tree)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_reference(arch, dtype):
    jm, jp = jax_model(arch, dtype)
    rb, tb = batch(arch)
    (rl, rmet), rg = jax.value_and_grad(jm.loss, has_aux=True)(jp, rb)
    m = port_model(arch, dtype)
    m.requires_grad_(True)
    loss, tmet = m.loss(tb, attention="plain")
    tl, tmet = loss.detach(), {k: v.detach() for k, v in tmet.items()}
    assert set(tmet) == {"ce", "z_loss", "aux"} and float(tmet["aux"]) == 0
    tol = 1e-5 if dtype == "float32" else 2e-2
    for got, ref in ((tl, rl), (tmet["ce"], rmet["ce"])):
        assert abs(float(got) - float(ref)) <= tol * abs(float(ref))
    assert abs(float(tmet["z_loss"]) - float(rmet["z_loss"])) <= \
        tol * abs(float(rmet["z_loss"]))
    own = dict(m.named_parameters())
    grads = dict(zip(own, torch.autograd.grad(loss, list(own.values()))))
    ref = tree_from_jax(to_f32(rg), m)
    assert set(ref) == set(grads)
    for name, g in grads.items():
        got, r = g.float().numpy(), ref[name]
        if dtype == "float32":
            err = np.abs(got - r).max()
            assert err <= 1e-3 * np.abs(r).max(), (name, err)
        else:
            err = np.linalg.norm(got - r)
            assert err <= 0.3 * np.linalg.norm(r), (name, err)


def test_remat_changes_no_gradient():
    """Layer and KV-block checkpoints recompute the same forward: the
    gradients equal those of a run without them, bit for bit."""
    _, tb = batch("qwen2.5-32b")
    out = []
    for remat in (True, False):
        m = port_model("qwen2.5-32b", "float32")
        m.cfg = dataclasses.replace(m.cfg, remat=remat)
        m.requires_grad_(True)
        loss, _ = m.loss(tb, attention="plain")
        out.append(torch.autograd.grad(loss, list(m.parameters())))
    for a, b in zip(*out):
        assert torch.equal(a, b)


def test_forward_routes_and_serving_keep_their_behaviour():
    """forward() still defaults to the kernel's route; on the CPU both
    routes differentiate, and the plain one gives the same logits."""
    m = port_model("smollm-360m", "float32")
    tok = torch.from_numpy(np.random.default_rng(2).integers(0, 512, (2, 8)))
    with torch.no_grad():
        np.testing.assert_allclose(m(tok).numpy(),
                                   m(tok, attention="plain").numpy(),
                                   rtol=0, atol=2e-5)
    with pytest.raises(ValueError, match="attention must be one of"):
        m(tok, attention="sdpa")
    assert not any(p.requires_grad for p in m.parameters())
    q = torch.randn(1, 2, 8, 16, requires_grad=True)
    out = mha(q, q.detach(), q.detach())      # the CPU's plain version
    out.sum().backward()
    assert q.grad is not None


# -- the train step --------------------------------------------------------------

def rel_norm(got, ref) -> float:
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [1.0, None])
@pytest.mark.parametrize("microbatches", [1, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch, microbatches, clip, dtype):
    jm, jp = jax_model(arch, dtype)
    rb, tb = batch(arch)
    ropt = radamw.AdamW(learning_rate=1e-3, grad_clip_norm=clip)
    rp, ro, rmet = jax.jit(r_make_train_step(jm, ropt, microbatches))(
        jp, ropt.init(jp), rb)
    m = port_model(arch, dtype)
    before = {k: v.detach().float().numpy().copy()
              for k, v in m.named_parameters()}
    opt = adamw.AdamW(learning_rate=1e-3, grad_clip_norm=clip)
    params = dict(m.named_parameters())
    tp, to, tmet = make_train_step(m, opt, microbatches)(
        params, opt.init(params), tb)
    assert tp["embed.tokens"] is m.embed.tokens       # updated in place
    assert set(tmet) == set(rmet) == {"ce", "z_loss", "aux", "loss",
                                      "step"}
    assert float(tmet["step"]) == float(rmet["step"]) == 1.0
    assert abs(float(tmet["loss"]) - float(rmet["loss"])) <= \
        2e-2 * abs(float(rmet["loss"]))
    ref, ref0 = tree_from_jax(to_f32(rp), m), tree_from_jax(to_f32(jp), m)
    for name, p in tp.items():
        got = p.detach().float().numpy()
        np.testing.assert_allclose(got, ref[name], rtol=0, atol=3e-3,
                                   err_msg=name)
        upd, rupd = got - before[name], ref[name] - ref0[name]
        if dtype == "float32":
            assert rel_norm(upd, rupd) <= 5e-2, name
        else:
            ratio = np.linalg.norm(upd) / np.linalg.norm(rupd)
            assert 0.9 <= ratio <= 1.1, (name, ratio)
    tol = {"float32": {"mu": 2e-3, "nu": 2e-3},
           "bfloat16": {"mu": 0.3, "nu": 0.6}}[dtype]
    for moment, bound in tol.items():
        for name, r in tree_from_jax(to_f32(ro[moment]), m).items():
            assert rel_norm(to[moment][name].numpy(), r) <= bound, \
                (moment, name)


@pytest.mark.parametrize("clip", [1.0, None])
def test_microbatched_step_matches_single_batch(clip):
    """The reference's test of the same name on the port, and beside its
    parameters at 3e-3 the update and the moments: ||update_4 -
    update_1|| within 0.15 of ||update_1|| (measured 0.046), mu and nu
    within 2e-2 (0.0025 and 0.0047)."""
    losses, params, updates, states = [], [], [], []
    for mb in (1, 4):
        m = port_model("granite-3-8b", "bfloat16")
        before = {k: v.detach().float().clone()
                  for k, v in m.named_parameters()}
        opt = adamw.AdamW(learning_rate=1e-3, grad_clip_norm=clip)
        p = dict(m.named_parameters())
        p, st, met = make_train_step(m, opt, mb)(
            p, opt.init(p), batch("granite-3-8b", packed=False)[1])
        losses.append(float(met["loss"]))
        params.append({k: v.detach().float() for k, v in p.items()})
        updates.append({k: (v - before[k]).numpy()
                        for k, v in params[-1].items()})
        states.append(st)
    assert abs(losses[0] - losses[1]) < 1e-5
    for k in params[0]:
        torch.testing.assert_close(params[0][k], params[1][k], rtol=0,
                                   atol=3e-3)
        assert rel_norm(updates[1][k], updates[0][k]) <= 0.15, k
        for moment in ("mu", "nu"):
            assert rel_norm(states[1][moment][k].numpy(),
                            states[0][moment][k].numpy()) <= 2e-2, \
                (moment, k)


def test_a_restored_state_is_loaded_into_the_module():
    m = port_model("smollm-360m", "float32")
    copy = {k: v.detach().clone() + 1 for k, v in m.named_parameters()}
    own = load_params(m, copy)
    assert own["final_norm"] is m.final_norm
    assert torch.equal(m.final_norm, copy["final_norm"])
    with pytest.raises(ValueError, match="microbatches"):
        opt = adamw.AdamW()
        make_train_step(m, opt, 3)(own, opt.init(own), batch("smollm-360m")[1])


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("dispatch", ["einsum", "gather"])
@pytest.mark.parametrize("remat", [True, False])
def test_step_spans_and_moe_counters(monkeypatch, remat, dispatch,
                                     microbatches):
    """Under a registry a step is one ``train.forward`` and one
    ``train.backward`` a microbatch and one ``train.optimizer``; the MoE
    counters equal a direct count of ``_positions``' ``keep`` in the
    same forward (``moe.load_max`` the busiest expert's token choices of
    each layer), once, though the layer checkpoint's recomputation
    routes again, and nothing else is counted; with the disabled
    registry nothing is counted."""
    from repro_torch import obs
    from repro_torch.models import moe

    base = get_reduced("deepseek-moe-16b")
    cfg = dataclasses.replace(
        base, dtype="float32", remat=remat,
        moe=dataclasses.replace(base.moe, capacity_factor=1.0,
                                dispatch=dispatch))
    m = LM(cfg, device="cpu", seed=0)
    g = torch.Generator().manual_seed(3)
    tokens = torch.randint(0, cfg.vocab, (4, 32), generator=g)
    tb = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    keeps = []
    positions = moe._positions

    def spy(top_e, e, c):
        pos, keep = positions(top_e, e, c)
        keeps.append((keep.clone(), e, c, top_e.clone()))
        return pos, keep

    def untouched(name):
        raise AssertionError("the disabled registry counted " + name)

    monkeypatch.setattr(moe, "_positions", spy)
    with torch.no_grad(), monkeypatch.context() as mp:
        mp.setattr(obs, "counter", untouched)
        m.loss(tb, attention="plain")
    want = {"moe.routed": sum(k.numel() for k, _, _, _ in keeps),
            "moe.dropped": sum(int((~k).sum()) for k, _, _, _ in keeps),
            "moe.slots": sum(k.shape[0] * e * c for k, e, c, _ in keeps),
            # A layer call's busiest expert, a microbatch's rows a call.
            "moe.load_max": sum(
                int(torch.bincount(rows.reshape(-1), minlength=e).max())
                for _, e, _, top_e in keeps
                for rows in top_e.chunk(microbatches))}
    assert len(keeps) == cfg.n_layers and want["moe.dropped"] > 0
    keeps.clear()
    opt = adamw.AdamW(learning_rate=1e-3)
    p = dict(m.named_parameters())
    tel = obs.Telemetry()
    with obs.use(tel):
        make_train_step(m, opt, microbatches)(p, opt.init(p), tb)
    # With remat the checkpoint routes each layer again in the backward.
    assert len(keeps) == cfg.n_layers * microbatches * (2 if remat else 1)
    assert tel.counters() == want
    spans = tel.spans_by_name()
    assert {k: v["count"] for k, v in spans.items()} == {
        "train.forward": microbatches, "train.backward": microbatches,
        "train.optimizer": 1}
    assert all(v["device_s"] is None for v in spans.values())
