"""The LM stack of the port: configs, parameter specs, layers, attention
(prefill through the Hopper flash-attention kernel), the MoE, Mamba and RWKV-6
mixers, blocks and the model of every family."""
