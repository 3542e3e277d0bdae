"""Post-hoc analysis of result JSONs (port of ``tvc/analysis``)."""

from tvc_torch.analysis.run_analysis import (  # noqa: F401
    UnifiedAnalysisRunner,
    generate_charts,
    generate_comprehensive_report,
    generate_latex_tables,
)
