"""The plain reference: PyTorch in float32 (TF32 off) and numpy.  It
imports nothing of the program and takes nothing the program made."""
