"""Plain references in PyTorch or NumPy. They import nothing of the
program and take nothing the program made."""
