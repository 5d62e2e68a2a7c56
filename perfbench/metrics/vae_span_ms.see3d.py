"""Milliseconds of the VAE's encode and decode per inpaint call on the
device's timeline (the `g4s:see3d.vae` spans over the `g4s:see3d.call`
spans): the program's own counterpart of `vae_ms.see3d`."""
from perfbench.program_spans import CALL, per


def read(trace):
    return per(trace.annotations, "g4s:see3d.vae", CALL)
