"""The benchmark's general machinery: the spec, the seeded inputs, the
closed-loop generator, spans and the trace reduction, the roofline table
and the result line.  Nothing here is specific to one configuration,
traffic mix or metric: those are files found by name."""
