"""paddle_tpu_torch — the PyTorch / CUDA port of paddle_tpu.

The same fluid-style surface as `paddle_tpu` (Program IR, `layers`,
Executor, the continuous-batching serving engine), with torch as the
compute substrate: op lowerings are plain torch functions run eagerly, and
each kernel the JAX package wrote in Pallas for the TPU is a CUDA kernel
written by hand for Hopper (csrc/). Entry points run on CUDAPlace(0) unless
the caller passes CPUPlace(). This package imports neither jax nor
paddle_tpu.

Ported so far: the serving path (`ContinuousBatchingEngine` over
`transformer_lm_decode_tick`, with the fused decode-attention kernel, and
the paged KV engine with its pinned host tier, weight-quantized and
speculative serving and `paged_beam_search` over it; `EngineServer` /
`EngineClient` with /metrics and /healthz, `PredictorServer`, the span
ring, the memory watermarks and the KV sanitizer); the training step (`transformer_lm` and the encoder-decoder `transformer`,
`optimizer.Adam(...).minimize(loss)` through `append_backward` on
torch.autograd, with the flash-attention forward and backward kernels,
dropout, gradient clipping, weight decay and the learning-rate
schedules); the recurrent models with their whole-sequence kernels; and
the high-level API: `Trainer` (events, checkpoints, resume), `io`
save/load in the JAX package's format, `Inferencer` / `Predictor`; and
the image models (ResNet, SE-ResNeXt, VGG, MNIST, AlexNet, GoogLeNet) on
conv, pool and batch_norm, fed uint8 images through `DevicePrefetcher`;
the SSD detector and the CRNN-CTC recognizer with the detection and CTC
ops; every op the JAX package registers, and its host-side `metrics`; the
program analyzers (`analyze_program`, `check_program`, `infer_program`,
`verify_program`, dataflow), the memory planner (`memory_plan_pass`), the
cost model, the measured memory census, the cost ledger, the flight
recorder and the `profiler` over torch.profiler.
ROADMAP.md lists what is still to be ported.
"""

from . import clip, initializer, layers, optimizer, regularizer  # noqa: F401
from .core import (CPUPlace, CUDAPlace, Place, default_place,  # noqa: F401
                   device_count, devices, is_compiled_with_cuda)
from .core import flags, unique_name  # noqa: F401
from .framework.analysis import (analyze_program, check_program,  # noqa: F401
                                 infer_program, op_loc, verify_program)
from .framework.backward import append_backward, calc_gradient  # noqa: F401
from .framework.executor import Executor  # noqa: F401
from .framework.passes import (Analyzer, Pass, get_pass,  # noqa: F401
                               register_pass, registered_passes)
from .framework.program import (Program, Variable,  # noqa: F401
                                default_main_program, default_startup_program,
                                program_guard, reset_default_programs)
from .framework.registry import registered_ops  # noqa: F401
from .framework.scope import Scope, global_scope, reset_global_scope  # noqa: F401
from .framework.selected_rows import SelectedRows  # noqa: F401
from .param_attr import ParamAttr  # noqa: F401
from . import data, io, models, nets, observability, serving  # noqa: F401,E402
from . import average, distributed, transpiler  # noqa: F401,E402
from . import evaluator, metrics  # noqa: F401,E402
from . import inferencer, trainer  # noqa: F401,E402
from .data.feeder import DataFeeder  # noqa: F401,E402
from .inferencer import Inferencer, Predictor  # noqa: F401,E402
from .io import (load_inference_model, load_numpy_params,  # noqa: F401,E402
                 load_params, load_persistables, load_vars,
                 save_inference_model, save_params, save_persistables,
                 save_vars)
from . import profiler, serving_engine  # noqa: F401,E402
from .serving import (ContinuousBatchingEngine,  # noqa: F401,E402
                      EngineClient, EngineServer, HostTierConfig,
                      PagedKVEngine, SpecConfig, paged_beam_search)
from .trainer import (BeginEpochEvent, BeginStepEvent,  # noqa: F401,E402
                      CheckpointConfig, EndEpochEvent, EndStepEvent,
                      Trainer, load_checkpoint, save_checkpoint)

__version__ = "0.1.0"
