"""The benchmark's machinery: the spec, seeded parameters, the run record
the readers get, the trace reduction and the check."""
