"""One module a job (``traffic`` files name it): ``Job`` builds the system's
train step and says how to call it, what its first step captures and how
to time its pieces."""
