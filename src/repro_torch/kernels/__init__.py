"""The port's kernels: hand-written CUDA for Hopper (``csrc/``), each bound
with ``ctypes`` (``_build``) and wrapped beside its plain PyTorch version
(``l1ball``, ``codegen.lowering``)."""
