"""Multi-scale deformable attention's backward against its roofline, in
the train step: the least time of the backward's work
(``arith/deform.py``) over the device time of every kernel launched
between the gradient's arrival at the op's output and its inputs' gradients,
over the instrumented traced stretch."""

from perfbench.common import deformwrap

LAYER = "kernel ms_deform_attn (ops/ms_deform_attn.py, csrc/ms_deform_attn.cu)"
UNIT = "%"
MOVES = "train_img_per_s"
ENTRY = "odise_torch.models.decoder.pixel_decoder:ms_deform_attn"


def install(run):
    return deformwrap.install(run, ENTRY)


def read(run):
    return deformwrap.share(run, backward=True)
