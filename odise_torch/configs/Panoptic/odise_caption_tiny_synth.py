# Tiny synthetic caption-supervised smoke config (full caption CLI path:
# word tokens, grounding criterion, binary mask losses).
import numpy as np

from odise_torch.config import L, get_config
from odise_torch.data.catalog import DatasetCatalog, MetadataCatalog
from odise_torch.data.dataset_mapper import COCOPanopticDatasetMapper
from odise_torch.data.loader import build_train_loader
from odise_torch.losses import CriterionConfig, GroundingConfig
from odise_torch.model_zoo.factory import build_caption_odise

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
            "captions": ["a thing on some stuff", "another thing"],
            "words": ["thing", "stuff"],
        })
    return records


if "_tiny_synth_cap" not in DatasetCatalog:
    DatasetCatalog.register("_tiny_synth_cap", _synthetic_records)
MetadataCatalog.get("_tiny_synth_cap").set(
    ignore_label=255,
    categories=[{"id": i, "isthing": int(i < 2), "name": l[0]}
                for i, l in enumerate(_LABELS)])

model = L(build_caption_odise)(
    scale="tiny",
    train_labels=_LABELS,
    with_clip_head=False,
    use_checkpoint=False,
    slide_training=True,
)

criterion = L(CriterionConfig)(num_classes=1, num_points=64)
grounding_criterion = L(GroundingConfig)(loss_weight=1.0, collect_mode=None)

dataloader = dict(
    train=L(build_train_loader)(
        dataset="_tiny_synth_cap",
        mapper=L(COCOPanopticDatasetMapper)(
            is_train=True, image_size=64, max_instances=4,
            with_captions=True, num_words=4),
        total_batch_size=2,
    ),
    wrapper=dict(
        labels=[list(l) for l in _LABELS],
        dataset_name="_tiny_synth_cap",
        semantic_on=True,
        panoptic_on=True,
        instance_on=True,
    ),
    eval_short_side=64,
    eval_max_size=128,
)

train = get_config("common/train.py").train
train.max_iter = 2
train.log_period = 1
train.eval_period = 0
train.checkpointer.period = 2
train.output_dir = "./output/tiny_synth_cap"

optimizer = get_config("common/optim.py").AdamW
optimizer.milestones = [2]
