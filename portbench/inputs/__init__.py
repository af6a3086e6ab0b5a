"""Initial conditions of the benchmark's configurations, made on the
device from the run's seed: one module per case, named by the
``inputs`` key of a configuration's file, with ``make(conf, seed,
device)`` returning the fields handed to the program and to the
reference alike."""
