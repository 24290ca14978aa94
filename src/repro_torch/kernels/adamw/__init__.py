"""AdamW's per-leaf passes: csrc/adamw.cu's two kernels (the gradients'
sums of squares, the fused update) and their plain PyTorch versions."""
