# COCO panoptic train/test loaders + evaluators
# (reference configs/common/data/coco_panoptic_semseg.py:40-95).
from odise_torch.config import L
from odise_torch.data.build import get_openseg_labels
from odise_torch.data.dataset_mapper import COCOPanopticDatasetMapper
from odise_torch.data.loader import build_test_loader, build_train_loader

dataloader = dict(
    train=L(build_train_loader)(
        dataset="coco_2017_train_panoptic_with_sem_seg",
        mapper=L(COCOPanopticDatasetMapper)(
            is_train=True,
            image_size=1024,
            max_instances=100,
        ),
        total_batch_size=64,
        seed=42,
    ),
    test=L(build_test_loader)(
        dataset="coco_2017_val_panoptic_with_sem_seg",
        batch_size=1,
    ),
    # open-vocab eval bundle for the main task (COCO, prompt-engineered)
    wrapper=dict(
        labels=L(get_openseg_labels)(dataset="coco_panoptic", prompt_engineered=True),
        dataset_name="coco_2017_val_panoptic_with_sem_seg",
        semantic_on=True,
        instance_on=True,
        panoptic_on=True,
    ),
    eval_short_side=1024,
    eval_max_size=2560,
)
