"""CAPre's static analysis on the port: the access plan of a step
(``access_plan``)."""
