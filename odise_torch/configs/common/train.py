# Common training options (reference configs/common/train.py:20-49).
from odise_torch.config import ConfigDict

train = dict(
    output_dir="./output",
    init_checkpoint="",
    max_iter=92188,
    bf16=True,  # read by nothing, as in odise_tpu: the modules compute in float32
    grad_clip=0.01,
    checkpointer=dict(period=4500, max_to_keep=2, backend="torch"),
    eval_period=5000,
    log_period=50,
    device="cuda",
    seed=42,
    wandb=dict(enable_writer=False, project="odise_torch", resume=False),
    run_name="",
    run_tag="",
    reference_world_size=0,
    cfg_name="",
)
