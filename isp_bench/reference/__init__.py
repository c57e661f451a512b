"""The plain reference: plain PyTorch and NumPy that imports nothing of the
program, run after the window to decide ``correct``."""
