from .abft_guard import ABFTGuard, GuardConfig  # noqa: F401
from .watchdog import StragglerWatchdog  # noqa: F401
