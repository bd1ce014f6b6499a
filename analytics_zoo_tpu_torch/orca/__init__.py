"""Orca: the training front end of the port."""
