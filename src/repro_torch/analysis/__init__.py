"""Static checks of the port's own code (port of ``repro/analysis``'s
lint suite): ``python -m repro_torch.analysis`` runs the passes ``sync``
(``hostsync``), ``span`` (``spans``) and ``counter`` (``counters``) over
``src/repro_torch``; ``lint`` is their framework."""

from .lint import (Finding, LintPass, Module, all_passes, load_baseline,
                   partition_baseline, run_passes, run_paths, save_baseline)

__all__ = [
    "Finding", "LintPass", "Module", "all_passes", "load_baseline",
    "partition_baseline", "run_passes", "run_paths", "save_baseline",
]
