"""Prior networks: for See3D the MV-UNet with its DDIM sampler and
pipeline, the VAE and the two CLIP towers; DepthAnything V2 (DINOv2 and the
DPT head) for the depth lift."""
