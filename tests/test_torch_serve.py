"""The port's serving path (``repro_torch.serve.engine``,
``repro_torch.launch.serve``) on the CPU: greedy generation gives the JAX
package's tokens in float32 on the same weights for every architecture
(the enc-dec and VLM families with their frontend embeddings), and the
launcher runs every architecture with ``--device cpu`` and raises
without a card otherwise."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from _numpy_weights import numpy_tree  # noqa: E402

from repro.configs import get_reduced as r_get_reduced  # noqa: E402
from repro.models.model import LM as RLM  # noqa: E402
from repro.models.params import Spec as RSpec  # noqa: E402
from repro.serve.engine import Engine as REngine  # noqa: E402
from repro_torch.configs import ARCHS, get_reduced  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.serve.engine import Engine, make_serve_step  # noqa: E402

DENSE = ["smollm-360m", "granite-3-8b", "qwen2.5-32b", "nemotron-4-15b"]


def f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_gives_the_references_tokens_in_float32(arch):
    """The dense configs on the reference's own init, the other families
    on numpy weights (``tests/_numpy_weights.py``), with numpy frame or
    patch embeddings."""
    rm = RLM(f32(r_get_reduced(arch)))
    if arch in DENSE:
        rp = jax.tree.map(np.asarray, rm.init(jax.random.PRNGKey(0)))
    else:
        rp = numpy_tree(rm.specs(), 3, RSpec)
    m = LM(f32(get_reduced(arch)), device="cpu")
    m.load_state_dict(params_from_jax(rp, m))
    rng = np.random.default_rng(2)
    prompts = rng.integers(0, rm.vocab_real, (3, 10))
    fe = m.cfg.frontend
    front = None if fe is None else rng.standard_normal(
        (3, fe.n_positions, fe.d_frontend)).astype(np.float32)
    t_max = 24 + m.n_front
    want = REngine(rm, jax.tree.map(jnp.asarray, rp), t_max=t_max).generate(
        jnp.asarray(prompts), 8,
        frontend=None if front is None else jnp.asarray(front))
    got = Engine(m, t_max=t_max).generate(
        torch.from_numpy(prompts), 8,
        frontend=None if front is None else torch.from_numpy(front))
    assert got.shape == (3, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_serve_step_is_greedy_and_updates_the_cache_in_place():
    m = LM(get_reduced("granite-3-8b"), device="cpu", seed=4)
    tok = torch.tensor([[3, 9, 27], [1, 2, 5]])
    logits, caches = m.prefill(tok, 8)
    assert logits.shape == (2, 1, m.cfg.vocab)
    k3 = caches[0]["k"][:, 3].clone()
    assert k3.abs().max() == 0
    nxt, step_logits, same = make_serve_step(m)(caches, tok[:, -1:], 3)
    assert same is caches and caches[0]["k"][:, 3].abs().max() > 0
    assert torch.equal(nxt[:, 0], step_logits[:, -1].argmax(-1))


def test_generate_refuses_more_tokens_than_the_cache_holds():
    m = LM(get_reduced("smollm-360m"), device="cpu")
    with pytest.raises(ValueError, match="t_max"):
        Engine(m, t_max=8).generate(torch.zeros((1, 6), dtype=torch.long), 4)
    m = LM(get_reduced("internvl2-2b"), device="cpu")     # 8 prefix positions
    with pytest.raises(ValueError, match="8 prefix"):
        Engine(m, t_max=16).generate(torch.zeros((1, 6), dtype=torch.long),
                                     4, frontend=torch.zeros((1, 8, 32)))


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_runs_on_the_cpu(capsys, arch):
    launch_serve.main(["--arch", arch, "--new", "5", "--batch", "2",
                       "--prompt-len", "6", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(":")[0] for ln in lines] == ["seq0", "seq1"]
    assert all(len(ln.split(",")) == 5 for ln in lines)


def test_launcher_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch_serve.main(["--arch", "smollm-360m", "--new", "2"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LM(get_reduced("qwen2.5-32b"))


def test_launcher_dry_run_waits_for_the_distribution_layer():
    with pytest.raises(NotImplementedError, match="item 9"):
        launch_serve.main(["--arch", "qwen2.5-32b", "--dry-run"])
