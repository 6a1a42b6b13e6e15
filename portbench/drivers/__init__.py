"""Cell drivers: set-up, one study, the program's outputs, the numbers."""
