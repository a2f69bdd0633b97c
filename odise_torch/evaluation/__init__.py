"""Open-vocabulary evaluation: shape buckets, statistics on the device, host
evaluators and the eval loop (counterpart of ``odise_tpu/evaluation``)."""

from .evaluator import DatasetEvaluators, inference_on_dataset, print_csv_format
from .instance_eval import InstanceSegEvaluator
from .panoptic_eval import PanopticEvaluator, PQStat, pq_compute_single
from .sem_seg_eval import SemSegEvaluator
