"""Traffic drivers: one module a kind of traffic, named by a traffic
file's ``driver``.  Each has ``setup``, ``warm``, ``window``,
``release``, ``check``, ``failed`` and ``close`` of a ``run.Run``."""
