"""Multi-scale deformable attention's forward against its roofline, in the
eval call: the least time of its work (``arith/deform.py``: bytes at the
HBM rate or float32 operations over the inside corners) over the device
time of every kernel launched inside the op's forward range, over the
instrumented traced stretch."""

from perfbench.common import deformwrap

LAYER = "kernel ms_deform_attn (ops/ms_deform_attn.py, csrc/ms_deform_attn.cu)"
UNIT = "%"
MOVES = "infer_img_per_s"
ENTRY = "odise_torch.models.decoder.pixel_decoder:ms_deform_attn"


def install(run):
    return deformwrap.install(run, ENTRY)


def read(run):
    return deformwrap.share(run, backward=False)
