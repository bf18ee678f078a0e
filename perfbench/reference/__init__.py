"""The plain reference the outputs are checked against. It imports
nothing of the program."""
