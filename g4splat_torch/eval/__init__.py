"""Image and mesh metrics, and the synthetic box-room scene."""
