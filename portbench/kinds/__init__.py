"""Request kinds.  A traffic file names one (``"kind"``); the module of
that name here has a ``Stream`` that the harness builds with the problem
family, the configuration, the traffic and the data, and then calls:
``setup()`` once (counted in set-up), ``request(i)`` for each request of
the window, and ``close()`` to drop the program's state."""
