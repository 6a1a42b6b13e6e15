"""Plain references of the configurations; they import nothing of the program."""
