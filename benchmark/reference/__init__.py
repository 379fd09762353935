"""Plain references, work counts and peaks of the benchmark; they import
nothing of the program."""
