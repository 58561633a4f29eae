"""Roofline terms of the port's steps: the traffic models and the report
(`analysis`), and the cost counter that takes the place of the JAX
package's HLO analyzer (`counter`)."""
