"""VisualCloze in PyTorch and CUDA for NVIDIA Hopper (H100).

A port of the JAX/Pallas package `visualcloze_tpu`, which stays the
reference: same layout (ops/, models/, transport/, pipeline/), same public
layouts (NHWC VAE, (B, H, L, D) attention, HWIO conv weights), and every
Pallas kernel of the main path rewritten as a hand-written CUDA kernel under
csrc/. It imports nothing of the JAX package. Entry points run on the GPU
unless the caller passes device="cpu".
"""
