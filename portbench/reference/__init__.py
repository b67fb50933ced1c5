"""Plain PyTorch models that decide ``correct``.

Nothing here imports the program (``gfe_mamba_torch``), a kernel, or
JAX.  Each model is a function of a dict of tensors keyed by the
published state_dict names, so the benchmark hands the same drawn
weights to the program and to the reference.  ``precision.Rounding``
rounds the operands of every convolution and matrix product: identity
for the reference itself, TF32 or scaled fp8 for the control."""
