"""The entry paths of the program that cells drive, one module each, named
by a configuration file's ``driver`` key."""
