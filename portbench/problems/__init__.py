"""Problem families: each module generates a configuration's data from the
seed, states it as a problem of the program under test, and judges the
program's answers against the plain reference."""
