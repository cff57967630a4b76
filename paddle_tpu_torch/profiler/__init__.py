"""paddle_tpu_torch.profiler — the observability plane (counterpart of
``paddle_tpu/profiler``, with the reference's ``__all__``).

Host spans are recorded by the port's own lightweight recorder and
exported as chrome://tracing JSON; device-side tracing runs
``torch.profiler`` (Kineto over CUPTI) where the reference runs
``jax.profiler``, and ``xplane.correlate`` hands the card's measured time
back to the host spans. Besides: the metrics registry, the structured
event log, the training-health plane, the retrace watchdog and compile
attribution (CUDA-graph captures and kernel builds), the step-window
``ThroughputMonitor``, the serving engine's request tracer (``reqtrace``)
and SLO tracker (``slo``), and the ``ObservabilityServer``.
"""
from . import compile_watch
from . import device_time
from . import events
from . import health
from .health import HealthMonitor
from . import metrics
from .monitor import (ThroughputMonitor, make_step_record,
                      validate_step_record)
from . import server
from . import xplane
from .profiler import (Profiler, ProfilerState, ProfilerTarget,
                       export_chrome_tracing, export_protobuf, make_scheduler)
from .statistic import SortedKeys, StatisticData, summary_report
from .timer import Benchmark, benchmark
from .utils import RecordEvent, load_profiler_result
from .watchdog import RetraceWatchdog, get_watchdog

compile_watch.install()

__all__ = [
    'Profiler', 'ProfilerState', 'ProfilerTarget', 'make_scheduler',
    'export_chrome_tracing', 'export_protobuf', 'RecordEvent',
    'load_profiler_result', 'SortedKeys', 'StatisticData', 'summary_report',
    'Benchmark', 'benchmark', 'metrics', 'events', 'compile_watch',
    'device_time', 'health', 'server', 'xplane', 'ThroughputMonitor',
    'HealthMonitor', 'make_step_record', 'validate_step_record',
    'RetraceWatchdog', 'get_watchdog',
]
