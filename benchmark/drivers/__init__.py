"""General drivers of the program's entry points.  A traffic mix
(``traffic/<mix>.json``) names one by its ``driver`` key; a driver reads the
mix's parameters and nothing else of a cell.

A driver has ``setup()`` (the program built and every shape of the mix
warmed), ``unit(i, spans)`` (one work unit: a batch, or an image's group of
questions; it ends in a host read of its answers), ``traced_unit(i)``,
``release()`` and ``check(units)`` (the comparison with the reference)."""
