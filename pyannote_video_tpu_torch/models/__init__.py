"""Networks: layers, packaged weights, the face detector and its refiner."""
