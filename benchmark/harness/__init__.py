"""The benchmark's harness: inputs from the seed, the loops of the
traffic kinds, the trace reader, the work counts and the check."""
