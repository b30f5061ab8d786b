"""Model modules of the port: FLUX DiT, VAE, T5 and CLIP text encoders."""
