"""Fault tolerance of the port: the state-integrity guard (``guard``)
the Simulation consults at chunk edges, the chaos injectors
(``injectors``: NaN/Inf and bit flips in the state, a flaky event
transport, process faults, truncated files) and the FAULT command that
binds them to a running sim or worker (``harness``), ports of the JAX
package's ``fault/``."""
from .guard import IntegrityGuard                      # noqa: F401
from .injectors import (FlakySocket, inject_nonfinite,  # noqa: F401
                        truncate_file)
from .harness import fault_command                     # noqa: F401
