"""BCEdge core: the paper's contribution — the utility objective and the
discrete max-entropy SAC scheduler — with the interference predictor and
the baseline schedulers (``core.baselines``)."""
from repro_torch.core.sac import SACAgent, SACConfig  # noqa: F401
from repro_torch.core.utility import scheduling_slot, utility  # noqa: F401
