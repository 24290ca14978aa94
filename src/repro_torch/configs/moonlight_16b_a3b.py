"""moonlight-16b-a3b [moe, mla]: Moonlight-16B-A3B as published
[hf:moonshotai/Moonlight-16B-A3B config.json, model_type deepseek_v3;
arXiv:2502.16982]: 27 layers, the first a dense SwiGLU of width 11,264,
the other 26 MoE (64 routed experts of width 1,408, top-6, 2 shared);
multi-head latent attention (no query latent, kv latent 512, q/k heads
128 + 64 rotary, v heads 128); a sigmoid router that chooses by score
plus a balancing bias (``noaux_tc``, one group), weights renormalised
and scaled by 2.446, a sequence-wise balance loss.

Departures from the published model: rotary embeddings rotate halves
(the port's layout), where the published modeling code first
de-interleaves each pair, which on random weights is a fixed
permutation of the rotary columns of ``wq`` and ``wkva``. Sizes the
published file does not give: the balance loss's alpha 0.001 (the
``deepseek_v3`` config class's default) and the bias's step 0.001
(DeepSeek-V3 §2.1.2); the capacity factor 1.25 with drops is the port's
MoE layer, as deepseek-moe-16b's.
"""
from repro_torch.models.config import MlaConfig, ModelConfig, MoeConfig

CONFIG = ModelConfig(
    name="moonlight-16b-a3b", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=11264, vocab=163840, mlp="swiglu", rope_theta=50_000.0,
    rms_eps=1e-5, first_k_dense=1,
    mla=MlaConfig(kv_lora_rank=512, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
    moe=MoeConfig(n_experts=64, top_k=6, n_shared=2, d_expert=1408,
                  router_aux_weight=0.001, scoring="sigmoid",
                  routed_scale=2.446, bias_rate=0.001),
)

REDUCED = ModelConfig(
    name="moonlight-16b-a3b-reduced", family="moe",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=160, vocab=512, mlp="swiglu", rope_theta=50_000.0,
    rms_eps=1e-5, first_k_dense=1,
    mla=MlaConfig(kv_lora_rank=32, qk_nope_head_dim=16,
                  qk_rope_head_dim=8, v_head_dim=16),
    moe=MoeConfig(capacity_factor=8.0, n_experts=8, top_k=2, n_shared=1,
                  d_expert=32, router_aux_weight=0.001, scoring="sigmoid",
                  routed_scale=2.446, bias_rate=0.001),
)
