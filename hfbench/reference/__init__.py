"""Plain references that decide whether a run is correct. They import
nothing of the program."""
