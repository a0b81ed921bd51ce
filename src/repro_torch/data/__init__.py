"""Data generators (numpy, seeded): ListOps from its grammar and synthetic
LM streams. Copies of the JAX package's modules of the same names."""
from repro_torch.data.listops import generate_listops, make_listops_batch  # noqa: F401
from repro_torch.data.synthetic import lm_batch_iterator, synthetic_task_batch  # noqa: F401
