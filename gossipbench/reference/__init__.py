"""The plain reference (plain torch and NumPy; nothing of the program)."""
