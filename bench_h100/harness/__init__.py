"""The benchmark's harness: cells found by name, inputs from the seed,
the timed window, the trace and its readers, and the comparison that
decides `correct`.  Nothing here imports the program at module level."""
