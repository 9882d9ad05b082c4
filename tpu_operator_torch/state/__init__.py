from .skel import SyncState, StateSkel, is_daemonset_ready
from .manager import Manager, StateResult

__all__ = ["SyncState", "StateSkel", "Manager", "StateResult", "is_daemonset_ready"]
