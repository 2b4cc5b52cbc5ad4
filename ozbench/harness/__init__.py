"""The harness of the benchmark of ``ozimmu_tpu_torch``: finding a cell's
pieces (``spec``), the drivers' base and the window (``driver``), the window's
statistics (``stats``), the card (``device``), the traced run
(``tracing``, ``readers``) and the rooflines (``roofline``)."""
