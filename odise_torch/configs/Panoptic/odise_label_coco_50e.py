# ODISE label-supervised, COCO 50 epochs
# (reference configs/Panoptic/odise_label_coco_50e.py:27-57).
from odise_torch.config import get_config

_model = get_config("common/models/odise_with_label.py")
model = _model.model
criterion = _model.criterion
dataloader = get_config("common/data/coco_panoptic_semseg.py").dataloader
train = get_config("common/train.py").train
optimizer = get_config("common/optim.py").AdamW

train.max_iter = 92188            # 50 epochs @ global batch 64
train.grad_clip = 0.01
train.checkpointer.period = 4500
train.eval_period = 5000
train.reference_world_size = 32   # workers the schedule was tuned for

optimizer.lr = 1e-4
optimizer.weight_decay = 0.05
optimizer.grad_clip = "${train.grad_clip}"
# milestones of a 184,375-iter (100e) schedule, applied to the 50e run
optimizer.milestones = [163889, 177546]
# linear warmup, COCO LSJ setting (reference odise_label_coco_50e.py:41-43:
# warmup_length = 500/184375 iters of the 100e schedule, factor 0.067)
optimizer.warmup_steps = 500
optimizer.warmup_factor = 0.067

# extra open-vocab eval tasks (large vocabularies only at the final iter)
_eval = get_config("common/data/pano_open_d2_eval.py")
extra_task = dict(
    eval_ade150=dict(task=_eval.ade150, final_iter_only=False),
    eval_ctx59=dict(task=_eval.ctx59, final_iter_only=False),
    eval_ade847=dict(task=_eval.ade847, final_iter_only=True),
    eval_ctx459=dict(task=_eval.ctx459, final_iter_only=True),
    eval_pas21=dict(task=_eval.pas21, final_iter_only=False),
)
