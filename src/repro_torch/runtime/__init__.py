from .abft_guard import (ABFTGuard, GuardConfig,  # noqa: F401
                         UnverifiableBatch)
from .watchdog import StragglerWatchdog  # noqa: F401
