"""One reader a metric: ``<name>.py`` defines ``read(run)``, which returns
the metric's value from a :class:`portbench.harness.Run`, or None where
the run holds nothing to read."""
