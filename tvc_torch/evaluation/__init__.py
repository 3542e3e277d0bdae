"""Experiment evaluation and dataset validation (port of ``tvc/evaluation``)."""

from tvc_torch.evaluation.data_validator import (  # noqa: F401
    DataValidationConfig,
    DataValidator,
    ValidationResult,
)
from tvc_torch.evaluation.experiment_evaluator import (  # noqa: F401
    ExperimentConfig,
    ExperimentEvaluator,
    ExperimentResult,
)
