"""The training path: AdamW with fp32 or int8 moments (``optimizer``), the
train step with gradient accumulation (``train_step``), atomic async
checkpoints in the reference's layout (``checkpoint``) and the leaf order
they share (``tree``), elastic training - checkpoint, failure, re-attach
to a surviving device, exact resume (``elastic``) - and int8
error-feedback gradient compression over a process group
(``grad_compress``)."""
from .elastic import ElasticConfig, ElasticTrainer  # noqa: F401
from .grad_compress import compress_allreduce  # noqa: F401
