"""The plain reference that decides `correct`: Marlin's indexer and
verifier in Python ints (see judge.py).  It imports nothing of the program."""
