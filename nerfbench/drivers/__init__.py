"""The general loops that traffic mixes name by their ``driver`` key:
``train`` (the trainer's step loop) and ``serve`` (requests to the online
server's render function)."""
