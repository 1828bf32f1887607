from .metrics import (EvalResult, Metric, create_metrics,
                      default_metric_for_objective)

__all__ = ["EvalResult", "Metric", "create_metrics",
           "default_metric_for_objective"]
