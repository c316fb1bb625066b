# Hand-written CUDA kernels for Hopper (sources in ../csrc/):
#   gnep_sweep/ - the paper's RM candidate-price sweep (P5 inner loop)
#   gnep_iter/  - fused Alg. 4.1 inner iteration middle (fill/objective/argmax)
# Each has kernel.py (ctypes wrapper + launch counter), ops.py (solver
# plug-ins) and ref.py (the plain PyTorch version the wrapper runs on CPU
# tensors and the card's checks compare against).
