"""The plain reference the benchmark compares the port with (imports no program code)."""
