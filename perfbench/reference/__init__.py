"""The plain reference: NumPy code that works out from the raw rows and the
genome arrays what a circuit answers.  It imports nothing of the program."""
