"""The plain reference of the training cells: float32 PyTorch with TF32
off (or, as the control, every product's operands rounded to fp8), and
frozen copies of the flood fill and the plan's tables. It imports nothing
of the program: it makes its parameters from the seed (bench/harness/
params.py), reads the configuration file and the pool of batches, and
works the plan out again."""
