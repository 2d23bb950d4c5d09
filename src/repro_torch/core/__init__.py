"""The staging simulator: a numpy discrete-event model of the shared FS,
the interconnect, the node-local stores and the many-task engine. It moves
real bytes under simulated time; nothing here runs on the card."""
