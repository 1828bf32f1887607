"""Boosting-model families (counterpart of ``lightgbm_tpu/models/
__init__.py``; reference boosting.cpp:35 factory)."""
from ..config import Config
from ..utils import log
from .dart import DART
from .gbdt import GBDT
from .goss import GOSS
from .rf import RF

_ALIASES = {"gbdt": "gbdt", "gbrt": "gbdt", "dart": "dart", "goss": "goss",
            "rf": "rf", "random_forest": "rf"}


def create_boosting(config: Config, train_set, objective, metrics=(), *,
                    device, timer=None) -> GBDT:
    """Boosting::CreateBoosting: gbdt | dart | goss | rf."""
    name = config.boosting.strip().lower()
    if name not in _ALIASES:
        log.fatal("Unknown boosting type %s", name)
    cls = {"gbdt": GBDT, "dart": DART, "goss": GOSS,
           "rf": RF}[_ALIASES[name]]
    return cls(config, train_set, objective, metrics, device=device,
               timer=timer)


__all__ = ["DART", "GBDT", "GOSS", "RF", "create_boosting"]
