"""The lint passes.  Importing this package registers every rule.

Rule ids (see each module for the full story):

* ``host-sync`` — blocking device->host transfers in core/serve must
  be registered ``_note_host_transfer`` sites or pragma'd.
* ``jit-purity`` — no Python control flow on captured tensors, print,
  global mutation, or wall-clock/RNG inside functions handed to
  ``graph_loop.run`` / ``while_`` / ``cond``.
* ``static-argnames`` — a ``graph_loop.run`` capture key must hold
  every enclosing parameter the captured function reads.
* ``publish-freeze`` — arrays published by the serve layer must pass
  through the ``freeze()`` helper.
* ``scatter-determinism`` — executor scatters (``index_add_``,
  ``scatter_reduce_``, ``index_put_`` ...) must use a combine
  registered commutative-associative in operators.py.
* ``dtype-narrowing`` — narrowing casts in core/ must be a
  ``wire_narrow``-declared safe narrowing from operators.py.
* ``bad-pragma`` — suppression pragmas must be well-formed.
"""
from . import dtype_narrowing  # noqa: F401
from . import host_sync  # noqa: F401
from . import jit_purity  # noqa: F401
from . import pragma_hygiene  # noqa: F401
from . import publish_freeze  # noqa: F401
from . import scatter_determinism  # noqa: F401
from . import static_args  # noqa: F401
