"""Binary orbital-delay kernels: the unit-free orbital math.

Counterpart of ``pint_tpu/models/binaries/``: pure torch and DD kernel
code of per-TOA tensors and scalar parameters, differentiated by
``torch.func.jacfwd`` of the whole phase (no hand-written derivative
chain).  The wrapper components that marshal parameters into them are in
``models/pulsar_binary.py``.
"""
