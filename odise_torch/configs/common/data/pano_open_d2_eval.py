# Open-vocabulary evaluation task bundles
# (reference configs/common/data/pano_open_d2_eval.py:35-235): per-dataset
# loader + vocabulary + evaluator list. Semantic-only for the large
# vocabularies (A-847, PC-459, PAS-21).
from odise_torch.config import L
from odise_torch.data.build import get_openseg_labels
from odise_torch.data.loader import build_test_loader


def _task(dataset_name, labels_key, *, semantic_on=True, instance_on=True,
          panoptic_on=True):
    return dict(
        loader=L(build_test_loader)(dataset=dataset_name, batch_size=1),
        wrapper=dict(
            labels=L(get_openseg_labels)(dataset=labels_key, prompt_engineered=True),
            dataset_name=dataset_name,
            semantic_on=semantic_on,
            instance_on=instance_on,
            panoptic_on=panoptic_on,
        ),
    )


coco = _task("coco_2017_val_panoptic_with_sem_seg", "coco_panoptic")
ade150 = _task("ade20k_panoptic_val", "ade20k_150")
ade847 = _task("ade20k_full_sem_seg_val", "ade20k_847",
               instance_on=False, panoptic_on=False)
ctx59 = _task("ctx59_sem_seg_val", "pascal_context_59",
              instance_on=False, panoptic_on=False)
ctx459 = _task("ctx459_sem_seg_val", "pascal_context_459",
               instance_on=False, panoptic_on=False)
pas21 = _task("pascal21_sem_seg_val", "pascal_voc_21",
              instance_on=False, panoptic_on=False)
