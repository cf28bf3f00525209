from . import dtypes, enforce, flags, places, unique_name  # noqa: F401
from .enforce import (EnforceError, InvalidArgumentError, NotFoundError,  # noqa: F401
                      enforce)
from .flags import get_flag, set_flag  # noqa: F401
from .places import (CPUPlace, CUDAPlace, Place, default_place,  # noqa: F401
                     device_count, devices, is_compiled_with_cuda,
                     place_to_device)
