"""The MoE dispatch's slot positions: csrc/moe_positions.cu's kernel.
Its plain PyTorch version, the CPU's route and the card tests' oracle,
is ``models/moe.py:_positions_plain``."""
