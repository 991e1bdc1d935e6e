"""The plain reference of the benchmark: NumPy and PyTorch code written
for it, which imports nothing of the program under test."""
