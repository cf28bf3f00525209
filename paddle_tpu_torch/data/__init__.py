"""Input pipelines (≙ paddle_tpu/data): the reader decorators, the
synthetic datasets, the DataFeeder with byte-lean staging, the device
prefetcher, batch packing and the RecordIO container with its threaded
native loader (the dataset downloader is not copied: no network)."""

from . import common  # noqa: F401
from . import datasets  # noqa: F401
from .decorator import (batch, buffered, chain, compose, firstn,  # noqa: F401
                        map_readers, shuffle, xmap_readers)
from .feeder import (DataFeeder, stage_array, stage_batch,  # noqa: F401
                     staging_specs)
from .packing import pack_lm_batch, pack_sequences  # noqa: F401
from .prefetch import DevicePrefetcher  # noqa: F401
from .recordio import (ParallelRecordLoader, RecordIOScanner,  # noqa: F401
                       RecordIOWriter, read_numpy_records,
                       write_numpy_records)
