"""The task modules of the traffic kinds, one each, named by a traffic file's ``task``."""
