"""Circuit evaluation: live-gate programs (`program`), hand-written CUDA
kernels (`circuit_eval`), their plain PyTorch versions (`ref`), and
device-dispatching wrappers (`ops`)."""
