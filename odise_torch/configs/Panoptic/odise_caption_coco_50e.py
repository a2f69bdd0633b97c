# ODISE caption-supervised, COCO 50 epochs
# (reference configs/Panoptic/odise_caption_coco_50e.py:27-59).
from odise_torch.config import L, get_config
from odise_torch.data.dataset_mapper import COCOPanopticDatasetMapper

_model = get_config("common/models/odise_with_caption.py")
model = _model.model
criterion = _model.criterion
grounding_criterion = _model.grounding_criterion
dataloader = get_config("common/data/coco_panoptic_semseg.py").dataloader
train = get_config("common/train.py").train
optimizer = get_config("common/optim.py").AdamW

# caption-augmented train split with word sampling
dataloader.train.dataset = "coco_2017_train_panoptic_caption_with_sem_seg"
dataloader.train.mapper = L(COCOPanopticDatasetMapper)(
    is_train=True,
    image_size=1024,
    max_instances=100,
    with_captions=True,
    num_words=8,
)

train.max_iter = 92188
train.grad_clip = 0.01
train.checkpointer.period = 4500
train.eval_period = 5000
train.reference_world_size = 32

optimizer.lr = 1e-4
optimizer.weight_decay = 0.05
optimizer.grad_clip = "${train.grad_clip}"
optimizer.milestones = [163889, 177546]
# linear warmup, COCO LSJ setting (reference odise_caption_coco_50e.py:40-42)
optimizer.warmup_steps = 500
optimizer.warmup_factor = 0.067

_eval = get_config("common/data/pano_open_d2_eval.py")
extra_task = dict(
    eval_ade150=dict(task=_eval.ade150, final_iter_only=False),
    eval_ctx59=dict(task=_eval.ctx59, final_iter_only=False),
    eval_ade847=dict(task=_eval.ade847, final_iter_only=True),
    eval_ctx459=dict(task=_eval.ctx459, final_iter_only=True),
    eval_pas21=dict(task=_eval.pas21, final_iter_only=False),
)
