"""Prior networks of the See3D stage: the MV-UNet with its DDIM sampler and
pipeline, the VAE, and the two CLIP towers."""
