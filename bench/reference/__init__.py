"""The plain reference that decides ``correct``: plain PyTorch, f32 with TF32
off, importing nothing of the program under test."""
