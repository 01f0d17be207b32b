"""Plain references that decide ``correct``.

Each module here imports numpy or torch and nothing of the program under
test: it works the answer out again from the inputs the benchmark made.
"""
