"""The paper's tables on the port: ``run`` (Tables 1-2, the §3.3/§4.2 DWS
sequence, the §3.2 convergence, the kernels' times) and ``dws_model``
(the depthwise-separable net of §3.3)."""
