# Tiny synthetic smoke config: exercises the full train CLI end-to-end
# (model build, loader, optimizer, checkpointing) without real datasets or
# the full-size towers. Not a benchmark config.
import numpy as np

from odise_torch.config import L, get_config
from odise_torch.data.catalog import DatasetCatalog, MetadataCatalog
from odise_torch.data.dataset_mapper import COCOPanopticDatasetMapper
from odise_torch.data.loader import build_train_loader
from odise_torch.losses import CriterionConfig
from odise_torch.model_zoo.factory import build_category_odise

_LABELS = (("thing a",), ("thing b",), ("stuff c",))


def _synthetic_records(n=8, size=64, seed=0):
    rng = np.random.RandomState(seed)
    records = []
    for i in range(n):
        pan = np.zeros((size, size), np.uint32)
        pan[: size // 2] = 1
        pan[size // 2:] = 2
        records.append({
            "image": rng.randint(0, 255, (size, size, 3), np.uint8),
            "pan_seg": pan,
            "image_id": i,
            "segments_info": [
                {"id": 1, "category_id": rng.randint(0, 2), "iscrowd": 0},
                {"id": 2, "category_id": 2, "iscrowd": 0},
            ],
        })
    return records


if "_tiny_synth" not in DatasetCatalog:
    DatasetCatalog.register("_tiny_synth", _synthetic_records)
MetadataCatalog.get("_tiny_synth").set(
    ignore_label=255,
    categories=[{"id": i, "isthing": int(i < 2), "name": l[0]}
                for i, l in enumerate(_LABELS)])

model = L(build_category_odise)(
    scale="tiny",
    train_labels=_LABELS,
    with_clip_head=False,
    use_checkpoint=False,
    slide_training=True,
)

criterion = L(CriterionConfig)(num_classes=3, num_points=64)

dataloader = dict(
    train=L(build_train_loader)(
        dataset="_tiny_synth",
        mapper=L(COCOPanopticDatasetMapper)(
            is_train=True, image_size=64, max_instances=4),
        total_batch_size=2,
    ),
    wrapper=dict(
        labels=[list(l) for l in _LABELS],
        dataset_name="_tiny_synth",
        semantic_on=True,
        panoptic_on=True,
        instance_on=True,
    ),
    eval_short_side=64,
    eval_max_size=128,
)

train = get_config("common/train.py").train
train.max_iter = 3
train.log_period = 1
train.eval_period = 0
train.checkpointer.period = 2
train.output_dir = "./output/tiny_synth"

optimizer = get_config("common/optim.py").AdamW
optimizer.milestones = [2]
