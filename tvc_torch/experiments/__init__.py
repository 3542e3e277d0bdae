"""Experiment harness (port of ``tvc/experiments``)."""

from tvc_torch.experiments.four_scenarios import (  # noqa: F401
    FourScenariosConfig,
    FourScenariosExperiment,
)
from tvc_torch.experiments.harness import (  # noqa: F401
    ABLATION_VARIANTS,
    BASELINE_METHODS,
    ExperimentHarness,
    HarnessConfig,
    main,
    parse_args,
)
