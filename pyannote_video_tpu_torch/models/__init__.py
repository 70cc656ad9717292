"""Networks: layers, packaged weights, the face detector and its refiner,
the landmark cascade, face chips, the embedder, the fused detect → align →
embed program and the dlib model-file converters."""
