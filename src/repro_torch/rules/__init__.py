"""Labels -> decision tree -> design rules (paper §IV).

* :mod:`repro_torch.rules.labels` — §IV-A convolution/peak performance
  classes;
* :mod:`repro_torch.rules.trees` — CART (:class:`DecisionTree`), the
  Algorithm-1 sweep, :class:`RegressionTree`, and the out-of-core
  histogram grower, on one shared split kernel and :class:`Presort`;
* :mod:`repro_torch.rules.rulesets` — §IV-D/§V rulesets;
* :mod:`repro_torch.rules.boost` — :class:`GradientBoostedSurrogate`,
  the ``"boost"`` surrogate;
* :mod:`repro_torch.rules.pipeline` — :func:`distill`, search result
  -> :class:`RuleReport`, dense or out of core.

This package never imports :mod:`repro_torch.search` at runtime: the
dependency points search -> rules.
"""
from repro_torch.rules.boost import (GradientBoostedSurrogate,
                                     OnlineSurrogateBase)
from repro_torch.rules.labels import (Labeling, find_peaks, label_times,
                                      peak_prominences, peak_prominences_loop,
                                      step_convolve)
from repro_torch.rules.pipeline import RuleReport, distill
from repro_torch.rules.rulesets import (Rule, RuleSet, annotate_vs_canonical,
                                        class_range_accuracy,
                                        class_range_accuracy_loop,
                                        extract_rulesets, render_rules_table,
                                        rules_by_class)
from repro_torch.rules.trees import (ClassCountHistogram, DecisionTree,
                                     HistogramGrower, Presort,
                                     RegressionTree, TreeSearchTrace,
                                     algorithm1, algorithm1_from_histograms,
                                     fit_from_histograms)

__all__ = ["GradientBoostedSurrogate", "OnlineSurrogateBase", "Labeling",
           "find_peaks", "label_times", "peak_prominences",
           "peak_prominences_loop", "step_convolve", "RuleReport", "distill",
           "Rule", "RuleSet", "annotate_vs_canonical", "class_range_accuracy",
           "class_range_accuracy_loop", "extract_rulesets",
           "render_rules_table", "rules_by_class",
           "ClassCountHistogram", "DecisionTree", "HistogramGrower",
           "Presort", "RegressionTree", "TreeSearchTrace", "algorithm1",
           "algorithm1_from_histograms", "fit_from_histograms"]
