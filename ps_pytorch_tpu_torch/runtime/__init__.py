"""The training loops (synchronous, multi-slice asynchronous and
asynchronous across processes), their checkpoints, the polling evaluator
and the metrics schema."""

from ps_pytorch_tpu_torch.runtime.async_trainer import (  # noqa: F401
    AsyncTrainer,
)
from ps_pytorch_tpu_torch.runtime.evaluator import Evaluator  # noqa: F401
from ps_pytorch_tpu_torch.runtime.multislice import (  # noqa: F401
    MultiSliceTrainer,
)
from ps_pytorch_tpu_torch.runtime.trainer import Trainer  # noqa: F401
