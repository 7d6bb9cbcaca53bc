"""The plain reference: plain torch, nothing of the program."""
