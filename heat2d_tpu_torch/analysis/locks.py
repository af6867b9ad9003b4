"""Lock factories for the threaded modules (serve/, resil/): the port's
copy of the part of ``heat2d_tpu/analysis/locks.py`` they use.

``AuditedLock(name)`` and ``AuditedCondition(name)`` return a plain
``threading.Lock`` / ``threading.Condition``, what the JAX package's
factories return while no lock auditor is installed; ``@guarded_by``
records which attributes of a class its named lock protects, in
``GUARDS``. The auditor that checks lock order and guarded writes at run
time (``install``/``report``) is not ported yet (ROADMAP.md, slice 7);
until then the names and the declarations keep the serve code as the JAX
package writes it, and the repo linter (rule R006) sees no bare lock in
a threaded module.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

#: classes registered with @guarded_by: cls -> (lock attr, guarded attrs)
GUARDS: Dict[type, Tuple[str, frozenset]] = {}


def AuditedLock(name: Optional[str] = None) -> threading.Lock:
    """A mutex (``name`` labels it for the auditor to come)."""
    return threading.Lock()


def AuditedCondition(name: Optional[str] = None) -> threading.Condition:
    """A condition variable over a fresh mutex."""
    return threading.Condition()


def guarded_by(lock_attr: str, *attrs: str):
    """Class decorator: declare that writes to ``attrs`` require
    ``self.<lock_attr>`` to be held. Registration only; the class is
    returned unchanged."""
    if not attrs:
        raise ValueError("guarded_by needs at least one guarded attr")

    def deco(cls: type) -> type:
        GUARDS[cls] = (lock_attr, frozenset(attrs))
        return cls

    return deco
