"""Plain float32 reference of what the benchmark runs; it imports nothing of the program."""
