"""The LM stack of the port: configs, parameter specs, layers, attention
(prefill through the Hopper flash-attention kernel), blocks and the
dense decoder-only model."""
